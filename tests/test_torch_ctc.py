"""PyTorch port, CTC loss (`ops/misc_ops.py` `ctc_loss`, `nd.ctc_loss`
and its aliases, `gluon.loss.CTCLoss`) against the JAX package's on the
CPU, float32, from the same seeded numpy activations and labels.

The op: blank 'first' and 'last' x label lengths derived from the
padding or given x data lengths T or given, each batch holding a label
that needs more frames than it has (4 equal labels need 7 of T = 6),
an empty label and one of length 1. Losses within 1e-5 relative
(ATen's alpha recursion and the JAX op's sum in other orders); the
infeasible label costs exactly the JAX op's 1e30. Gradients with
respect to the activations (through the float32 log-softmax) within
1e-5, with the infeasible sample's cotangent 0: there the port's
gradient is 0 (ATen's zero_infinity) and the JAX op's is the gradient of
its -1e30 stand-in. The block: layouts NTC and TNC x label layouts NT
and TN, with data and label lengths and `sample_weight`, within 1e-5
relative. The JAX references come from one `jax.jit`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import nd as ndj
from mxnet_tpu.gluon import loss as loss_j
from mxnet_tpu.ops import misc_ops as misc_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import loss as loss_t
from mxnet_tpu_torch.ops import misc_ops as misc_t

CPU = mxt.cpu()
T, N, C, L = 6, 5, 6, 4
DLEN = np.array([6, 5, 3, 6, 4], np.int32)
LLEN = np.array([4, 2, 0, 1, 3], np.int32)
# (blank_label, use_label_lengths, use_data_lengths)
CASES = [(blank, ul, ud) for blank in ("first", "last")
         for ul in (False, True) for ud in (False, True)]


def _case_id(c):
    return (f"blank_{c[0]}-{'given' if c[1] else 'derived'}_labels-"
            f"{'given' if c[2] else 'full'}_frames")


def _inputs(case):
    blank = case[0]
    rng = np.random.RandomState(CASES.index(case))
    x = rng.randn(T, N, C).astype(np.float32)
    lo, hi, pad = (1, C, 0) if blank == "first" else (0, C - 1, -1)
    lab = rng.randint(lo, hi, (N, L)).astype(np.int32)
    lab[0] = [2, 2, 2, 2]               # needs 7 frames: infeasible at T 6
    lab[4, :3] = [1, 2, 3]              # needs 3 of its 4 frames
    for n in range(N):
        lab[n, LLEN[n]:] = pad
    g = rng.randn(N).astype(np.float32)
    g[0] = 0.0
    return x, lab, g


def _jax_loss(case, x, lab):
    blank, ul, ud = case
    return misc_j.ctc_loss(x, lab, jnp.asarray(DLEN), jnp.asarray(LLEN),
                           use_data_lengths=ud, use_label_lengths=ul,
                           blank_label=blank)


@pytest.fixture(scope="module")
def jax_refs():
    """{case: (losses, gradient of losses . g)} from one jit."""
    def all_cases(args):
        out = []
        for c, (x, lab, g) in zip(CASES, args):
            loss, vjp = jax.vjp(lambda x_: _jax_loss(c, x_, lab), x)
            out.append((loss, vjp(g)[0]))
        return out
    args = [tuple(jnp.asarray(a) for a in _inputs(c)) for c in CASES]
    return {c: tuple(np.asarray(v) for v in r)
            for c, r in zip(CASES, jax.jit(all_cases)(args))}


def _port(case, x, lab):
    blank, ul, ud = case
    return misc_t.ctc_loss(x, torch.tensor(lab), torch.tensor(DLEN),
                           torch.tensor(LLEN), use_data_lengths=ud,
                           use_label_lengths=ul, blank_label=blank)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ctc_loss_matches_jax(case, jax_refs):
    x, lab, _ = _inputs(case)
    got = _port(case, torch.tensor(x), lab).numpy()
    want = jax_refs[case][0]
    assert want[0] == np.float32(1e30) and got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ctc_loss_gradient_matches_jax(case, jax_refs):
    x, lab, g = _inputs(case)
    xt = torch.tensor(x, requires_grad=True)
    _port(case, xt, lab).backward(torch.tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), jax_refs[case][1],
                               rtol=1e-5, atol=1e-5)


def test_ctc_infeasible_sample_has_no_gradient():
    case = CASES[0]
    x, lab, _ = _inputs(case)
    xt = torch.tensor(x, requires_grad=True)
    loss = _port(case, xt, lab)
    loss[0].backward()
    assert loss[0].item() == np.float32(1e30)
    assert torch.count_nonzero(xt.grad) == 0


def test_ctc_loss_names_on_ndarrays():
    """`nd.ctc_loss` and its aliases run the op on NDArrays (lengths as
    keyword NDArrays too), as `nd.contrib.ctc_loss` does."""
    case = ("first", True, False)
    x, lab, _ = _inputs(case)
    want = _port(case, torch.tensor(x), lab).numpy()
    args = (nd.array(x, ctx=CPU), nd.array(lab, ctx=CPU))
    kw = dict(use_label_lengths=True,
              label_lengths=nd.array(LLEN, ctx=CPU))
    for fn in (nd.ctc_loss, nd.CTCLoss, nd._contrib_ctc_loss,
               nd._contrib_CTCLoss, nd.contrib.ctc_loss, nd.contrib.CTCLoss):
        got = fn(*args, **kw)
        assert isinstance(got, nd.NDArray)
        np.testing.assert_array_equal(got.asnumpy(), want)


@pytest.mark.parametrize("layout,label_layout", [
    ("NTC", "NT"), ("NTC", "TN"), ("TNC", "NT"), ("TNC", "TN")])
def test_ctc_loss_block_matches_jax(layout, label_layout):
    case = ("first", True, True)
    x, lab, _ = _inputs(case)
    w = np.random.RandomState(9).rand(N).astype(np.float32)
    pred = x if layout == "TNC" else x.transpose(1, 0, 2)
    label = lab if label_layout == "NT" else lab.T
    arrs = (pred, label, DLEN, LLEN, w)
    want = loss_j.CTCLoss(layout, label_layout)(
        *[ndj.array(a) for a in arrs]).asnumpy()
    got = loss_t.CTCLoss(layout, label_layout)(
        *[nd.array(a, ctx=CPU) for a in arrs])
    assert isinstance(got, nd.NDArray) and got.shape == (N,)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=0)
    # without lengths: the labels' padding and every frame
    want = loss_j.CTCLoss(layout, label_layout)(
        ndj.array(pred), ndj.array(label)).asnumpy()
    got = loss_t.CTCLoss(layout, label_layout)(
        nd.array(pred, ctx=CPU), nd.array(label, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
