"""PyTorch port, the op registry (`mxnet_tpu_torch.ops.OPS`) against the
JAX package's (`mxnet_tpu.ops.OPS`) on the CPU: every registration of
`mxnet_tpu/ops/math_ops.py` and `nn_ops.py`, by its MXNet name, on the
same seeded numpy inputs with the same parameters.

Tolerances: float32 outputs within 1e-6 absolute (the inputs are chosen
so outputs are O(1)); reductions and the `linalg_*` family within 1e-5
relative; `linalg_syevd` and `linalg_gelqf` up to the sign of each
vector (LAPACK's choice); integer and bool outputs, and every output's
dtype, equal. `Dropout` is compared where it draws nothing (its masks
come from the two packages' different streams); its draws are held to
their statistics in `test_dropout_draws`. `_contrib_quantized_conv2d`
raises `NotPortedError` in the port (an int8 convolution, queue 1's
"What the GPT-2 lifecycle left out"). The registry is also reached
through `nd.<op>`, `NDArray.<op>` and `sym.<op>`, and SoftmaxOutput's
gradient (every normalization, with and without `use_ignore`) equals
`jax.grad`'s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import nd as nd_j
from mxnet_tpu import ops as ops_j
from mxnet_tpu.ops import math_ops as mo_j
from mxnet_tpu.ops import nn_ops as no_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import ops as ops_t
from mxnet_tpu_torch.ndarray.ndarray import NotPortedError

R = np.random.RandomState(0)


def u(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


A = u(3, 4)
B = u(3, 4)
BV = u(4)
POS = u(3, 4, lo=0.5, hi=2.0)
UNIT = u(3, 4, lo=-0.9, hi=0.9)
INTF = R.randint(-2, 3, (3, 4)).astype(np.float32)     # ties and equalities
INTF2 = R.randint(-2, 3, (3, 4)).astype(np.float32)
I32 = R.randint(-5, 6, (3, 4)).astype(np.int32)
X4 = u(2, 3, 6, 6)
SPD = (lambda m: (m @ m.T + 3 * np.eye(4)).astype(np.float32))(u(4, 4))
SPD3 = np.stack([SPD, SPD + np.eye(4, dtype=np.float32)])
TRI = np.tril(u(4, 4)) + 2 * np.eye(4, dtype=np.float32)
SQ = u(2, 4, 4) + 2 * np.eye(4, dtype=np.float32)
HALVES = np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, -2.5, 0.4, 0.6]],
                  np.float32)

_BINARY = ["elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
           "broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_div", "broadcast_maximum", "broadcast_minimum",
           "broadcast_hypot"]
_CMP = ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
        "broadcast_greater_equal", "broadcast_lesser",
        "broadcast_lesser_equal", "broadcast_logical_and",
        "broadcast_logical_or", "broadcast_logical_xor"]
_SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
           "_div_scalar", "_rdiv_scalar", "_power_scalar", "_rpower_scalar",
           "_mod_scalar", "_maximum_scalar", "_minimum_scalar"]
_SCALAR_CMP = ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
               "_greater_equal_scalar", "_lesser_scalar",
               "_lesser_equal_scalar"]
# unary ops and the inputs their domain takes
_UNARY = {
    "abs": A, "sign": INTF, "rint": HALVES, "round": HALVES, "ceil": A,
    "floor": A, "trunc": A, "fix": A, "square": A, "sqrt": POS,
    "rsqrt": POS, "cbrt": A, "rcbrt": POS, "exp": A, "log": POS,
    "log10": POS, "log2": POS, "log1p": POS, "expm1": A, "sin": A,
    "cos": A, "tan": A, "arcsin": UNIT, "arccos": UNIT, "arctan": A,
    "sinh": A, "cosh": A, "tanh": A, "arcsinh": A, "arccosh": POS + 1.0,
    "arctanh": UNIT, "degrees": A * 0.01, "radians": A, "erf": A,
    "erfinv": UNIT * 0.5, "gamma": POS, "gammaln": POS, "reciprocal": POS,
    "negative": A, "logical_not": INTF, "sigmoid": A, "softsign": A,
    "relu": A, "hard_sigmoid": A * 4}


def _cases():
    c = []
    for n in _BINARY:
        c.append((n, (A, B if n.startswith("elemwise") else BV), {}))
    c.append(("broadcast_mod", (A * 3, np.where(BV > 0, 0.5, -0.7)
                                .astype(np.float32)), {}))
    c.append(("broadcast_power", (POS, u(4, lo=-1.0, hi=2.0)), {}))
    for n in _CMP:
        c.append((n, (INTF, INTF2), {}))
    for n in _SCALAR:
        src = POS if n in ("_rdiv_scalar", "_power_scalar") else A
        c.append((n, (src,), {"scalar": 0.7}))
    c.append(("_rpower_scalar", (A,), {"scalar": 2.0}))
    c.append(("_mod_scalar", (A * 3,), {"scalar": -0.7}))
    for n in _SCALAR_CMP:
        c.append((n, (INTF,), {"scalar": 1.0}))
    for n, x in _UNARY.items():
        c.append((n, (x,), {}))
    c += [("hard_sigmoid", (A * 4,), {"alpha": 0.3, "beta": 0.4}),
          ("clip", (A,), {"a_min": -0.3, "a_max": 0.5}),
          ("cast", (A * 5,), {"dtype": "int32"}),
          ("cast", (I32,), {"dtype": "float32"}),
          ("Cast", (A,), {"dtype": "float16"}),
          ("copy", (A,), {})]
    x3 = u(2, 3, 4)
    for n in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min",
              "sum_axis"):
        c += [(n, (x3,), {}), (n, (x3,), {"axis": 1}),
              (n, (x3,), {"axis": (0, 2), "keepdims": True}),
              (n, (x3,), {"axis": 1, "exclude": True})]
    nan = A.copy()
    nan[0, 1] = nan[2, 3] = np.nan
    c += [("nansum", (nan,), {"axis": 1}), ("nanprod", (nan,), {}),
          ("sum", (I32,), {"axis": 0}), ("prod", (I32,), {"axis": 1}),
          ("mean", (I32,), {}), ("max", (I32,), {"axis": 1}),
          ("cumsum", (x3,), {}), ("cumsum", (x3,), {"axis": 1}),
          ("cumsum", (I32,), {"axis": 0}),
          ("cumsum", (x3,), {"axis": 2, "dtype": "float32"}),
          ("norm", (x3,), {}), ("norm", (x3,), {"ord": 1, "axis": 1}),
          ("norm", (x3,), {"axis": (1, 2), "keepdims": True}),
          ("argmax", (INTF,), {}), ("argmax", (INTF,), {"axis": 1}),
          ("argmax", (x3,), {"axis": 0, "keepdims": True}),
          ("argmin", (INTF,), {"axis": 0}), ("argmin", (x3,), {}),
          ("argmax_channel", (INTF,), {})]
    m34, m45, v4 = u(3, 4), u(4, 5), u(4)
    b34, b45 = u(2, 3, 4), u(2, 4, 5)
    c += [("dot", (m34, m45), {}), ("dot", (v4, v4), {}),
          ("dot", (u(4, 3), m45), {"transpose_a": True}),
          ("dot", (m34, u(5, 4)), {"transpose_b": True}),
          ("dot", (b34, m45), {}),
          ("batch_dot", (b34, b45), {}),
          ("batch_dot", (u(2, 4, 3), u(2, 5, 4)),
           {"transpose_a": True, "transpose_b": True}),
          ("linalg_gemm", (b34, b45, u(2, 3, 5)),
           {"alpha": 0.5, "beta": 2.0}),
          ("linalg_gemm", (u(2, 4, 3), b45, u(2, 3, 5)),
           {"transpose_a": True}),
          ("linalg_gemm2", (b34, u(2, 5, 4)),
           {"transpose_b": True, "alpha": 1.5}),
          ("linalg_potrf", (SPD3,), {}),
          ("linalg_syrk", (b34,), {"alpha": 0.5}),
          ("linalg_syrk", (b34,), {"transpose": True}),
          ("linalg_sumlogdiag", (SPD3,), {})]
    for right in (False, True):
        for lower in (True, False):
            for trans in (False, True):
                tri = TRI if lower else TRI.T.copy()
                rhs = u(4, 3) if not right else u(3, 4)
                c.append(("linalg_trsm", (tri, rhs),
                          {"rightside": right, "lower": lower,
                           "transpose": trans, "alpha": 0.5}))
                c.append(("linalg_trmm", (u(4, 4), rhs),
                          {"rightside": right, "lower": lower,
                           "transpose": trans, "alpha": 2.0}))
    for typ in ("indices", "value", "both", "mask"):
        c.append(("topk", (INTF,), {"k": 2, "ret_typ": typ}))
    c += [("topk", (x3,), {"axis": 1, "k": 2, "is_ascend": True,
                           "ret_typ": "both"}),
          ("topk", (INTF,), {"axis": 0, "k": 3, "dtype": "int32"}),
          ("sort", (INTF,), {}), ("sort", (x3,), {"axis": 1,
                                                  "is_ascend": False}),
          ("argsort", (INTF,), {}),
          ("argsort", (INTF,), {"axis": 0, "is_ascend": False}),
          ("argsort", (x3,), {"dtype": "int32"}),
          ("_zeros", (), {"shape": (2, 3)}),
          ("_ones", (), {"shape": (3,), "dtype": "int32"}),
          ("linalg_syevd", (SPD3,), {}), ("linalg_gelqf", (u(2, 3, 5),), {}),
          ("linalg_inverse", (SQ,), {}), ("linalg_det", (SQ,), {}),
          ("linalg_slogdet", (SQ,), {}),
          ("linalg_makediag", (u(2, 3),), {}),
          ("linalg_makediag", (u(3),), {"offset": 1}),
          ("linalg_makediag", (u(2, 3),), {"offset": -2}),
          ("linalg_extractdiag", (SQ,), {}),
          ("linalg_extractdiag", (SQ,), {"offset": -1}),
          ("linalg_maketrian", (u(2, 6),), {}),
          ("linalg_maketrian", (u(6),), {"lower": False}),
          ("linalg_maketrian", (u(3),), {"offset": 1}),
          ("linalg_maketrian", (u(2, 3),), {"offset": -1}),
          ("linalg_extracttrian", (SQ,), {}),
          ("linalg_extracttrian", (SQ,), {"lower": False}),
          ("linalg_extracttrian", (SQ,), {"offset": 2}),
          ("linalg_extracttrian", (SQ,), {"offset": -1}),
          ("digamma", (POS,), {}), ("log_sigmoid", (A * 3,), {}),
          ("mish", (A * 3,), {})]
    # nn_ops
    fcx, fcw, fcb = u(4, 2, 3), u(5, 6), u(5)
    c += [("FullyConnected", (fcx, fcw, fcb), {"num_hidden": 5}),
          ("FullyConnected", (fcx, u(5, 3), fcb),
           {"num_hidden": 5, "flatten": False}),
          ("FullyConnected", (fcx, fcw), {"num_hidden": 5, "no_bias": True}),
          ("Convolution", (X4, u(4, 3, 3, 3), u(4)),
           {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}),
          ("Convolution", (u(2, 4, 7, 7), u(6, 2, 3, 3), u(6)),
           {"kernel": (3, 3), "num_filter": 6, "stride": (2, 2),
            "dilate": (2, 1), "pad": (1, 0), "num_group": 2}),
          ("Convolution", (u(2, 3, 9), u(4, 3, 3)),
           {"kernel": (3,), "num_filter": 4, "no_bias": True}),
          ("Deconvolution", (u(2, 4, 5, 5), u(4, 3, 3, 3), u(3)),
           {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2),
            "pad": (1, 1), "adj": (1, 1)}),
          ("Deconvolution", (u(2, 4, 5, 5), u(4, 1, 2, 2)),
           {"kernel": (2, 2), "num_filter": 2, "num_group": 2,
            "no_bias": True}),
          ("Pooling", (X4,), {"kernel": (2, 2), "pool_type": "max"}),
          ("Pooling", (X4,), {"kernel": (3, 3), "stride": (2, 2),
                              "pad": (1, 1), "pool_type": "avg"}),
          ("Pooling", (X4,), {"kernel": (3, 3), "stride": (2, 2),
                              "pad": (1, 1), "pool_type": "avg",
                              "count_include_pad": False}),
          ("Pooling", (u(2, 3, 7, 7),), {"kernel": (2, 2), "stride": (2, 2),
                                         "pooling_convention": "full"}),
          ("Pooling", (X4,), {"kernel": (2, 2), "pool_type": "sum"}),
          ("Pooling", (X4,), {"kernel": (2, 2), "pool_type": "lp",
                              "p_value": 3}),
          ("Pooling", (X4,), {"global_pool": True, "pool_type": "avg"}),
          ("Pooling", (X4,), {"global_pool": True, "pool_type": "max"}),
          ("Pooling", (X4,), {"global_pool": True, "pool_type": "sum"})]
    for act in ("relu", "relu6", "sigmoid", "tanh", "softrelu", "softsign",
                "gelu", "silu"):
        c.append(("Activation", (A * 8,), {"act_type": act}))
    c += [("LeakyReLU", (A,), {"slope": 0.1}),
          ("LeakyReLU", (X4, u(3)), {"act_type": "prelu"}),
          ("LeakyReLU", (A * 3,), {"act_type": "elu", "slope": 0.7}),
          ("LeakyReLU", (A * 3,), {"act_type": "selu"}),
          ("LeakyReLU", (A * 3,), {"act_type": "gelu"}),
          ("LeakyReLU", (A * 3,), {"act_type": "rrelu"}),
          ("softmax", (x3,), {}), ("softmax", (x3,), {"axis": 1,
                                                      "temperature": 2.0}),
          ("softmax", (u(2, 5),), {"length": np.array([1, 3], np.int32)}),
          ("log_softmax", (x3,), {"axis": 0}),
          ("log_softmax", (x3,), {"temperature": 0.5}),
          ("softmin", (x3,), {"axis": 1}),
          ("SoftmaxOutput", (A, np.array([0, 3, 1], np.float32)), {}),
          ("SoftmaxOutput", (A,), {}),
          ("softmax_cross_entropy", (A, np.array([0, 3, 1], np.float32)), {}),
          ("Embedding", (np.array([[0, 2], [5, 1]], np.float32), u(6, 3)),
           {"input_dim": 6, "output_dim": 3}),
          ("embedding", (np.array([4, 0, 3], np.float32), u(6, 3)), {}),
          ("im2col", (X4,), {"kernel": (3, 3)}),
          ("im2col", (X4,), {"kernel": (2, 3), "stride": (2, 1),
                             "pad": (1, 1), "dilate": (1, 2)}),
          ("col2im", (u(2, 27, 16),), {"output_size": (6, 6),
                                       "kernel": (3, 3)}),
          ("col2im", (u(2, 18, 16),), {"output_size": (6, 6),
                                       "kernel": (2, 3), "stride": (2, 1),
                                       "pad": (1, 1), "dilate": (1, 2)}),
          ("Dropout", (A,), {"p": 0.5, "_training": False}),
          ("Dropout", (A,), {"p": 0.0, "_training": True}),
          ("Dropout", (A,), {"p": 0.0, "mode": "always"})]
    bn = (X4, u(3), u(3), u(3), u(3, lo=0.5, hi=1.5))
    c += [("BatchNorm", bn, {"_training": True}),
          ("BatchNorm", bn, {"_training": False}),
          ("BatchNorm", bn, {"_training": True, "momentum": 0.5,
                             "fix_gamma": True, "eps": 1e-3}),
          ("BatchNorm", bn, {"_training": True, "use_global_stats": True}),
          ("BatchNorm", (u(4, 5, 3), u(3), u(3), u(3),
                         u(3, lo=0.5, hi=1.5)), {"axis": -1,
                                                 "_training": True}),
          ("LayerNorm", (x3, u(4), u(4)), {}),
          ("LayerNorm", (x3, u(4), u(4)), {"eps": 1e-3,
                                           "output_mean_var": True}),
          ("LayerNorm", (u(2, 4, 4), u(4), u(4)), {"axis": 1}),
          ("GroupNorm", (u(2, 4, 3, 3), u(4), u(4)), {"num_groups": 2}),
          ("InstanceNorm", (X4, u(3), u(3)), {}),
          ("L2Normalization", (X4,), {}),
          ("L2Normalization", (X4,), {"mode": "channel"}),
          ("L2Normalization", (X4,), {"mode": "spatial"}),
          ("BilinearResize2D", (X4,), {"height": 9, "width": 12}),
          ("BilinearResize2D", (X4,), {"scale_height": 2.0,
                                       "scale_width": 1.5}),
          ("UpSampling", (X4,), {"scale": 2}),
          ("UpSampling", (X4,), {"scale": 3, "sample_type": "bilinear"})]
    qkv_i = u(5, 2, 3 * 2 * 8)
    att = u(4, 5, 5)
    q, k, v = u(2, 2, 5, 8), u(2, 2, 7, 8), u(2, 2, 7, 8)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3], np.float32)
    qkv = u(2, 6, 3 * 16)
    c += [("_contrib_interleaved_matmul_selfatt_qk", (qkv_i,), {"heads": 2}),
          ("_contrib_interleaved_matmul_selfatt_valatt", (qkv_i, att),
           {"heads": 2}),
          ("flash_attention", (q, k, v), {}),
          ("flash_attention", (q, k, v, mask), {"sm_scale": 0.3}),
          ("flash_attention", (q, q, q), {"causal": True}),
          ("flash_attention", (q, k, v), {"dropout": 0.3,
                                          "_training": False}),
          ("fused_self_attention", (qkv,), {"num_heads": 2}),
          ("fused_self_attention", (qkv, mask[:, :6]),
           {"num_heads": 2, "causal": True})]
    wq = R.randint(-127, 128, (5, 6)).astype(np.int8)
    ws = u(5, lo=0.01, hi=0.05)
    c += [("_contrib_quantized_dense", (u(3, 6), wq, ws, u(5)), {}),
          ("_contrib_quantized_dense", (u(3, 2, 3), wq, ws),
           {"act_scale": 0.01, "flatten": True, "relu": True}),
          ("_contrib_quantized_dense", (u(2, 4, 6), wq, ws, u(5)),
           {"relu": True})]
    return c


CASES = _cases()
_DIFF = {"linalg_syevd", "linalg_gelqf"}        # up to each vector's sign
_REL = {"sum", "mean", "prod", "nansum", "nanprod", "max", "min", "sum_axis",
        "cumsum", "norm", "dot", "batch_dot", "softmax_cross_entropy"}


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sign_fix(name, outs):
    """Each eigenvector (syevd's rows of U) or each row of gelqf's Q (and
    the matching column of L) with its largest entry positive."""
    if name == "linalg_syevd":
        u_, w = outs
        s = np.sign(np.take_along_axis(
            u_, np.abs(u_).argmax(-1)[..., None], -1))
        return [u_ * s, w]
    l_, q_ = outs
    s = np.sign(np.take_along_axis(q_, np.abs(q_).argmax(-1)[..., None], -1))
    return [l_ * np.swapaxes(s, -1, -2), q_ * s]


def _check(name, got, ref):
    got, ref = [_np(g) for g in _outs(got)], [_np(r) for r in _outs(ref)]
    assert len(got) == len(ref)
    if name in _DIFF:
        got, ref = _sign_fix(name, got), _sign_fix(name, ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, r)
        elif name in _REL or name.startswith("linalg_"):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_equals_the_jax_op(i):
    name, arrays, kw = CASES[i]
    kw_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    kw_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    ref = ops_j.OPS[name](*[jnp.asarray(a) for a in arrays], **kw_j)
    with mxt.cpu():
        got = ops_t.OPS[name](*[torch.from_numpy(np.array(a))
                                for a in arrays], **kw_t)
    _check(name, got, ref)


def _jax_names(*modules):
    names = {n for n, f in ops_j.OPS.items()
             if getattr(f, "__module__", "") in {m.__name__
                                                 for m in modules}}
    return names | {"sum_axis", "embedding"}


def test_every_jax_registration_is_in_the_one_registry_and_tested():
    names = _jax_names(mo_j, no_j)
    assert len(names) == 155
    assert names <= set(ops_t.OPS)
    tested = {c[0] for c in CASES} | {"_contrib_quantized_conv2d"}
    assert names <= tested, sorted(names - tested)


def test_quantized_conv2d_is_not_ported_yet():
    with pytest.raises(NotPortedError, match="What the GPT-2 lifecycle"):
        ops_t.OPS["_contrib_quantized_conv2d"](
            torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1, dtype=torch.int8),
            torch.ones(3))
    with pytest.raises(AttributeError):      # hasattr is False, as missing
        getattr(nd_t, "_contrib_quantized_conv2d")(
            torch.zeros(1), torch.zeros(1, dtype=torch.int8), torch.ones(1))


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_output_gradient_equals_jax(norm, use_ignore):
    """softmax - onehot, masked by ignore_label, normalised, times
    grad_scale; the head gradient is ignored."""
    x = u(2, 3, 5)
    lab = np.array([[0, 4, -1], [2, -1, 1]], np.float32)
    kw = dict(grad_scale=1.5, ignore_label=-1, use_ignore=use_ignore,
              normalization=norm)
    head = u(2, 3, 5)

    def loss_j(d):
        return jnp.sum(ops_j.OPS["SoftmaxOutput"](d, jnp.asarray(lab), **kw)
                       * jnp.asarray(head))
    ref = jax.grad(loss_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ops_t.OPS["SoftmaxOutput"](xt, torch.from_numpy(lab), **kw)
    (out * torch.from_numpy(head)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["nd", "method", "sym"])
def test_registry_reaches_nd_ndarray_and_sym(case):
    """The same registry op through `nd.<op>`, `NDArray.<op>` and a bound
    `sym.<op>` in both packages."""
    x = u(3, 4)
    if case == "nd":
        ref = nd_j.broadcast_hypot(nd_j.array(x), nd_j.array(BV))
        got = nd_t.broadcast_hypot(nd_t.array(x, ctx=mxt.cpu()),
                                   nd_t.array(BV, ctx=mxt.cpu()))
    elif case == "method":
        ref = nd_j.array(x).topk(k=2, ret_typ="value")
        got = nd_t.array(x, ctx=mxt.cpu()).topk(k=2, ret_typ="value")
    else:
        from mxnet_tpu import sym as sym_j
        from mxnet_tpu_torch import sym as sym_t
        outs = []
        for sym, nd, ctx in ((sym_j, nd_j, {}), (sym_t, nd_t,
                                                 {"ctx": mxt.cpu()})):
            a = sym.var("a")
            s = sym.log_softmax(sym.LeakyReLU(a, act_type="elu"), axis=0)
            outs.append(s.bind(args={"a": nd.array(x, **ctx)}).forward()[0])
        ref, got = outs
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=0,
                               atol=1e-6)


def test_dropout_draws():
    """In training: kept values scaled by 1/(1-p), the kept share near
    1-p, one draw shared along `axes`; mode "always" draws outside
    training too."""
    mxt.random.seed(0, "cpu")
    x = torch.ones(200, 300)
    out = ops_t.OPS["Dropout"](x, p=0.25, _training=True)
    kept = out != 0
    assert torch.all(out[kept] == torch.tensor(1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    out = ops_t.OPS["Dropout"](x, p=0.5, axes=(0,), _training=True)
    assert torch.all(out == out[:1])
    assert 0 < (out[0] != 0).sum() < 300
    out = ops_t.OPS["Dropout"](x, p=0.5, mode="always")
    assert 0 < (out != 0).sum() < x.numel()
