"""Why the float32 flash kernels may run on the tensor cores at all.

`csrc/flash_fwd.cu` computes the float32 forward's products (S = Q.K^T,
O += P.V) and `csrc/flash_bwd.cu` the float32 dq and dkv products in
split TF32 (`flash_common.cuh`): each float32 operand x is big = tf32(x) plus
small = tf32(x - big), both rounded to 10 mantissa bits, nearest, ties
away (the integer form of cvt.rna.tf32.f32), and each product a.b is
a_small.b_big + a_big.b_small + a_big.b_big on the tensor cores, a
k-step of 8 a product (m16n8k8 mma.sync). The tensor cores round each
accumulation toward zero, so the kernels sum two k-steps into a fresh
partial and add the partials in float32, rounded to nearest.

This file emulates that in numpy (products of two TF32 values are exact
in float64; each product's sum is cut to float32 toward zero) and holds
the forward's O and lse (the kernel's 32-key tiles and online softmax in
the exp2 domain) and the gradients against float64: at SQuAD
fine-tuning's sequence length
with a padding mask split TF32 stays within 1e-5 where plain TF32
misses the 1e-4 float32 gate of the card tests; and on a row whose every
key is masked (p = 1 for every key: dq sums 257 large terms) the
partials keep float32 accuracy where one accumulator chain drifts past
the gate, as it did on the card. `python -m tests.test_torch_flash_split_tf32`
from the repository's root prints the errors of every mode.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.cuda_ops import flash_attention as fa

_B, _H, _L, _D = 2, 3, 384, 64
_LENGTHS = (200, 384)


def tf32(x):
    """float32 x rounded to TF32 (10 mantissa bits, nearest, ties away
    from zero), as a float32: the kernel's `tf32_rna`."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def toward_zero(x):
    """float64 x cut to float32, rounded toward zero (a tensor-core
    accumulation)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def matmul(a, b, mode, acc=None):
    """acc + a @ b for float32 a (..., m, k) and b (..., k, n) (acc zeros
    if None), one k-step of 8 a tensor-core product: "split" as the
    kernels (split TF32, partials of two k-steps added to acc in
    float32), "split_chain" (split TF32, one accumulator chain), "tf32"
    (plain TF32, one chain)."""
    if acc is None:
        acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    part = acc
    for s in range(0, a.shape[-1], 8):
        x, y = a[..., s:s + 8], b[..., s:s + 8, :]
        if mode == "tf32":
            terms = ((tf32(x), tf32(y)),)
        else:
            (xb, xs), (yb, ys) = split(x), split(y)
            terms = ((xs, yb), (xb, ys), (xb, yb))       # small terms first
        if mode == "split" and s % 16 == 0:
            part = np.zeros_like(acc)                    # a fresh partial
        for u, w in terms:
            part = toward_zero(part.astype(np.float64)
                               + u.astype(np.float64) @ w.astype(np.float64))
        if mode != "split":
            acc = part
        elif s % 16 == 8 or s + 8 >= a.shape[-1]:
            acc = acc + part                             # to nearest
    return acc


def _case(seed=0, L=_L, D=_D, lengths=_LENGTHS):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(_B, _H, L, D).astype(np.float32)
                  for _ in range(4))
    bias = np.zeros((_B, L), np.float32)
    for b, n in enumerate(lengths):
        bias[b, n:] = -1e30
    return q, k, v, g, bias


def _gradients(q, k, v, g, bias, mode):
    """(dq, dk, dv) of softmax(q.k^T / sqrt(D) + bias).v with upstream g:
    in float64 for mode None, else with the kernels' five products in
    `mode` and their elementwise steps in float32, from the float64
    forward's lse and delta rounded to float32 (what the kernels read).
    As in the port, p = exp(s - lse): a row whose every key is masked
    has lse = -1e30 and p = 1 for every key, and delta is of the
    softmax's output."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    kt, vt = k.swapaxes(-1, -2), v.swapaxes(-1, -2)
    s64 = (q.astype(np.float64) @ kt.astype(np.float64)) * scale \
        + bias[:, None, None, :]
    top = s64.max(-1, keepdims=True)
    e = np.exp(s64 - top)
    lse = np.log(e.sum(-1, keepdims=True)) + top
    p64 = np.exp(s64 - lse)
    delta = (g.astype(np.float64) * ((e / e.sum(-1, keepdims=True))
                                     @ v.astype(np.float64))).sum(
        -1, keepdims=True)
    if mode is None:
        dp = g.astype(np.float64) @ vt.astype(np.float64)
        ds = p64 * (dp - delta) * scale
        return (ds @ k.astype(np.float64), ds.swapaxes(-1, -2) @ q,
                p64.swapaxes(-1, -2) @ g)
    lse32, delta32 = lse.astype(np.float32), delta.astype(np.float32)
    sc = matmul(q, kt, mode)
    p = np.exp(sc * np.float32(scale) + bias[:, None, None, :] - lse32)
    dp = matmul(g, vt, mode)
    ds = (p * (dp - delta32) * np.float32(scale)).astype(np.float32)
    return (matmul(ds, k, mode), matmul(ds.swapaxes(-1, -2), q, mode),
            matmul(p.astype(np.float32).swapaxes(-1, -2), g, mode))


_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)
_NEG2 = np.float32(-1e30) * _LOG2E          # the kernels' kNeg2


def _forward(q, k, v, bias, mode):
    """(O, lse (B, H, L)) of softmax(q.k^T / sqrt(D) + bias).v: in float64
    for mode None, else as the float32 forward kernel computes them: keys
    in the kernel's tiles of 32, S and P.V by `matmul` in `mode`, the online
    softmax in float32 in the exp2 domain (x = fma(s, sm_scale log2 e,
    bias log2 e), a running max from -1e30 log2 e, the tile's p scaling
    the running sum and O), O = acc / max(l, 1e-30) and lse = (m +
    log2 l) ln 2, or -1e30 for a row whose every key is masked."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    if mode is None:
        s64 = (q.astype(np.float64) @ k.swapaxes(-1, -2).astype(np.float64)) \
            * scale + bias[:, None, None, :]
        top = s64.max(-1, keepdims=True)
        e = np.exp(s64 - top)
        return ((e / e.sum(-1, keepdims=True)) @ v.astype(np.float64),
                (np.log(e.sum(-1, keepdims=True)) + top)[..., 0])
    tile = 32
    scale2 = np.float32(scale) * _LOG2E
    b2 = (bias * _LOG2E).astype(np.float32)[:, None, None, :]
    m = np.full(q.shape[:-1] + (1,), _NEG2, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    for k0 in range(0, k.shape[-2], tile):
        kt = k[..., k0:k0 + tile, :].swapaxes(-1, -2)
        sc = matmul(q, kt, mode)
        x = (sc.astype(np.float64) * scale2
             + b2[..., k0:k0 + tile]).astype(np.float32)     # one rounding
        mx = np.maximum(m, x.max(-1, keepdims=True))
        alpha = np.exp2(m - mx)
        m = mx
        p = np.exp2(x - m)
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        acc = matmul(p, v[..., k0:k0 + tile, :], mode, acc * alpha)
    l = np.maximum(l, np.float32(1e-30))
    lse = np.where(m == _NEG2, np.float32(-1e30),
                   (m + np.log2(l)) * _LN2)[..., 0]
    return acc * (np.float32(1.0) / l), lse


_FWD_CASES = {
    # SQuAD fine-tuning's length with a padding mask off the 64-key tiles
    "squad_like": dict(),
    # the card grid's edge: 257 keys, D = 96, batch row 1 fully masked
    "fully_masked_row": dict(seed=3, L=257, D=96, lengths=(170, 0)),
}
_fwd_cache = {}


def _forward_errors(name):
    """{mode: (max abs err of O, of lse)} against float64 for a case of
    `_FWD_CASES`, computed once."""
    if name not in _fwd_cache:
        q, k, v, _, bias = _case(**_FWD_CASES[name])
        ref_o, ref_lse = _forward(q, k, v, bias, None)
        _fwd_cache[name] = {}
        for mode in ("split", "split_chain", "tf32"):
            o, lse = _forward(q, k, v, bias, mode)
            _fwd_cache[name][mode] = (float(np.abs(o - ref_o).max()),
                                      float(np.abs(lse - ref_lse).max()))
    return _fwd_cache[name]


@pytest.mark.parametrize("name", sorted(_FWD_CASES))
def test_split_tf32_forward_holds_float32_accuracy(name):
    """The float32 forward's O and lse in split TF32 stay within 1e-5 of
    float64, where plain TF32 misses the 1e-4 gate of the card tests,
    also on a row whose every key is masked (O the mean of V, lse
    -1e30)."""
    err = _forward_errors(name)
    assert max(err["split"]) <= 1e-5, err
    assert max(err["tf32"]) > 1e-4, err


def test_port_plain_float32_forward_is_the_yardstick():
    """The forward's plain version, which the card tests hold the kernel
    to, is itself within 1e-5 of float64 at SQuAD's length with a padding
    mask, so the 1e-4 gate measures the kernel."""
    case = _case()
    q, k, v, _, bias = (torch.from_numpy(x) for x in case)
    o, lse = fa.flash_fwd_reference(q, k, v, bias)
    ref_o, ref_lse = _forward(*case[:3], case[4], None)
    assert np.abs(o.numpy().astype(np.float64) - ref_o).max() <= 1e-5
    assert np.abs(lse.numpy().reshape(ref_lse.shape) - ref_lse).max() <= 1e-5


@pytest.fixture(scope="module")
def grads():
    case = _case()
    return {mode: _gradients(*case, mode) for mode in (None, "split",
                                                       "tf32")}


def test_tf32_rounding_is_nearest_ties_away_and_split_is_exact_enough():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # TF32's ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                  one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                          np.float32))
    rng = np.random.RandomState(1)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-8, 8, 4096)).astype(
        np.float32)
    big, small = split(x)
    assert not (tf32(big) - big).any() and not (tf32(small) - small).any()
    rel = np.abs((big.astype(np.float64) + small) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("i,name", [(0, "dq"), (1, "dk"), (2, "dv")])
def test_split_tf32_gradients_hold_float32_accuracy(grads, i, name):
    ref = grads[None][i]
    err_split = np.abs(grads["split"][i] - ref).max()
    err_tf32 = np.abs(grads["tf32"][i] - ref).max()
    assert np.abs(ref).max() > 0.1, name
    assert err_split <= 1e-5, f"{name}: split TF32 max abs err {err_split}"
    assert err_tf32 > 1e-4, f"{name}: plain TF32 max abs err {err_tf32}"


def test_partial_sums_hold_a_fully_masked_row_to_float32_accuracy():
    """The card test's edge (257 x 257, D = 96, batch row 1 fully
    masked; |dq| reaches 80): one truncating accumulator chain per
    product drifts past 1e-4 (1.6e-4 on the card), the kernels' partials
    of two k-steps stay at float32's own accuracy."""
    case = _case(seed=3, L=257, D=96, lengths=(170, 0))
    ref = _gradients(*case, None)[0]
    err = {mode: np.abs(_gradients(*case, mode)[0] - ref).max()
           for mode in ("split", "split_chain")}
    assert np.abs(ref).max() > 20.0
    assert err["split"] <= 5e-5, err
    assert err["split_chain"] > 1e-4, err


def test_port_plain_float32_backward_is_the_yardstick(grads):
    """The plain version the card tests hold the kernels to is itself
    within 1e-5 of float64 here, so the 1e-4 gate measures the kernel."""
    q, k, v, g, bias = (torch.from_numpy(x) for x in _case())
    o, lse = fa.flash_fwd_reference(q, k, v, bias)
    delta = (g * o).sum(-1).reshape(_B * _H, _L)
    got = fa.flash_bwd_reference(q, k, v, bias, g, lse, delta)
    for name, a, ref in zip(("dq", "dk", "dv"), got, grads[None]):
        err = np.abs(a.numpy().astype(np.float64) - ref).max()
        assert err <= 1e-5, f"{name}: plain float32 max abs err {err}"


if __name__ == "__main__":
    # the emulated errors against float64, by mode: the forward's O and
    # lse, then the gradients
    for name in sorted(_FWD_CASES):
        for mode, (e_o, e_lse) in _forward_errors(name).items():
            print("forward", name, mode, {"O": e_o, "lse": e_lse})
    for label, case in (("SQuAD-like (2,3,384,64)", _case()),
                        ("fully masked row (2,3,257,96)",
                         _case(seed=3, L=257, D=96, lengths=(170, 0)))):
        ref = _gradients(*case, None)
        for mode in ("split", "split_chain", "tf32"):
            got = _gradients(*case, mode)
            print(label, mode, {name: float(np.abs(a - r).max()) for name, a, r
                                in zip(("dq", "dk", "dv"), got, ref)})
