"""Test oracles (counterpart of `mxnet_tpu/test_utils.py`; reference:
`python/mxnet/test_utils.py`).

`check_numeric_gradient` (finite differences against autograd's
backward) and `check_consistency` (one function on two execution paths).
The JAX package's `check_consistency` compares eager against `jax.jit`;
the port runs eagerly only, so here it has MXNet's own meaning: the
function on the CPU against the current device (the card). Where no
card is present it runs on the CPU alone and says so in what it returns.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd, context
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["assert_almost_equal", "check_numeric_gradient", "check_consistency",
           "default_rtol_atol", "rand_ndarray"]


def default_rtol_atol(dtype):
    dt = np.dtype(dtype)
    if dt.itemsize == 2:  # float16 / bfloat16
        return 1e-2, 1e-2
    if dt == np.float32:
        return 1e-4, 1e-5
    return 1e-6, 1e-8


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a, b = _to_np(a), _to_np(b)
    if rtol is None or atol is None:
        r, t = default_rtol_atol(a.dtype)
        rtol = rtol if rtol is not None else r
        atol = atol if atol is not None else t
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} != {names[1]}")


def rand_ndarray(shape, dtype="float32", scale=1.0):
    return nd.array(np.random.normal(0, scale, size=shape).astype(dtype))


def check_numeric_gradient(f, inputs, eps=1e-3, rtol=1e-2, atol=1e-3):
    """Finite-difference check of `f`'s backward.

    f: callable taking NDArrays, returning a single NDArray output.
    inputs: list of numpy arrays (float32 recommended; computed in f64 FD).
    """
    arrs = [nd.array(x.astype(np.float32)) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = f(*arrs)
        loss = out.sum() if out.shape != () else out
    loss.backward()
    sym_grads = [a.grad.asnumpy() for a in arrs]

    def fval(xs):
        with autograd.pause():
            return float(f(*[nd.array(x.astype(np.float32))
                             for x in xs]).sum().asscalar())

    for i, x in enumerate(inputs):
        num = np.zeros_like(x, dtype=np.float64)
        flat = x.reshape(-1)
        nflat = num.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            xs = [v.copy() for v in inputs]
            xs[i].reshape(-1)[j] = orig + eps
            fp = fval(xs)
            xs[i].reshape(-1)[j] = orig - eps
            fm = fval(xs)
            nflat[j] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(
            sym_grads[i], num, rtol=rtol, atol=atol,
            err_msg=f"numeric vs autograd gradient mismatch for input {i}")


def _outputs(out):
    return [_to_np(o) for o in (out if isinstance(out, (list, tuple))
                                else [out])]


def check_consistency(f, inputs, rtol=1e-5, atol=1e-6):
    """Run `f` on the CPU and on the card from the same numpy inputs and
    compare the outputs. Returns the contexts that ran: `[cpu(0),
    gpu(i)]`, or `[cpu(0)]` alone where no card is present (nothing was
    compared then)."""
    cpu = context.cpu(0)
    ref = _outputs(f(*[nd.array(x, ctx=cpu) for x in inputs]))
    if not torch.cuda.is_available():
        return [cpu]
    gpu = context.gpu(torch.cuda.current_device())
    got = _outputs(f(*[nd.array(x, ctx=gpu) for x in inputs]))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg="cpu vs gpu inconsistency")
    return [cpu, gpu]
