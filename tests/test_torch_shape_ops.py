"""PyTorch port, `ops.shape_ops` against the JAX package's
`mxnet_tpu.ops.shape_ops` on the CPU: every op of that module on the
same seeded numpy inputs, bit for bit (each op moves data, or computes
exactly: one_hot's products with 0 and 1, boolean_mask's products with
0 and 1). shape_array and size_array compare values: the JAX package
gives int32 (its x64 mode is off), the port int64 as MXNet does.

Then the same ops through `nd.<name>` and `NDArray.<name>` in both
packages, MXNet's reshape codes -2/-3/-4 (which the JAX op refuses)
against the shapes of MXNet's documentation, and take/pick's "clip" and
"wrap" modes on out-of-range and negative indices.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import nd as nd_j
from mxnet_tpu.ops import shape_ops as so_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch.ops import shape_ops as so_t

RNG = np.random.RandomState(0)
X = RNG.randn(2, 3, 4, 5).astype(np.float32)
M = RNG.randn(4, 6).astype(np.float32)
IDX = np.array([[0, 3, -1], [5, 2, 9]], np.float32)
LENS = np.array([2, 4, 1], np.int32)
SEQ = RNG.randn(4, 3, 2).astype(np.float32)
NDI = np.array([[0, 3], [5, 1]], np.int32)
PICK = np.array([1, -2, 7, 3], np.float32)

# (name in both modules, positional arrays, keyword arguments)
CASES = [
    ("reshape", (X,), {"shape": (0, -1, 5)}),
    ("reshape", (X,), {"shape": (-1, 0, 20)}),
    ("reshape", (X,), {"shape": None}),
    ("transpose", (X,), {"axes": (3, 1, 0, 2)}),
    ("transpose", (X,), {}),
    ("swapaxes", (X,), {"dim1": 1, "dim2": 3}),
    ("expand_dims", (M,), {"axis": 1}),
    ("expand_dims", (M,), {"axis": -1}),
    ("squeeze", (X[:, :1],), {"axis": 1}),
    ("squeeze", (X[:1, :, :1],), {}),
    ("flatten", (X,), {}),
    ("broadcast_to", (M[:1],), {"shape": (4, 0)}),
    ("broadcast_like", (M[:1], M), {}),
    ("broadcast_axis", (M[:, :1],), {"axis": 1, "size": 3}),
    ("broadcast_axis", (X[:, :1, :1],), {"axis": (1, 2), "size": (3, 2)}),
    ("tile", (M,), {"reps": (2, 1)}),
    ("tile", (M,), {"reps": (2, 1, 3)}),
    ("repeat", (M,), {"repeats": 2, "axis": 1}),
    ("repeat", (M,), {"repeats": 3}),
    ("pad", (X,), {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                   "constant_value": 0.5}),
    ("pad", (X,), {"mode": "edge", "pad_width": (0, 0, 1, 0, 1, 2, 2, 1)}),
    ("pad", (X,), {"mode": "reflect",
                   "pad_width": (0, 0, 2, 1, 2, 1, 1, 3)}),
    ("stack", (M, M * 2, M * 3), {"axis": 1}),
    ("concat", (M, M * 2), {"dim": 0}),
    ("concat", (X, X), {}),
    ("split", (M,), {"num_outputs": 3, "axis": 1}),
    ("split", (M,), {"num_outputs": 2, "axis": 0, "squeeze_axis": False}),
    ("split", (X,), {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
    ("split_v2", (M,), {"indices_or_sections": (1, 4), "axis": 1}),
    ("split_v2", (M,), {"indices_or_sections": 2}),
    ("slice", (X,), {"begin": (0, None, 1), "end": (2, None, -1),
                     "step": (1, -1, 2)}),
    ("slice", (M,), {"begin": (1, 0), "end": (3, 5)}),
    ("slice_axis", (X,), {"axis": 2, "begin": 1, "end": -1}),
    ("slice_axis", (X,), {"axis": 3, "begin": 2, "end": None}),
    ("slice_like", (M, M[:2, :3]), {}),
    ("slice_like", (X, M[:1, :2]), {"axes": (1,)}),
    ("reverse", (X,), {"axis": (1, 3)}),
    ("reverse", (M,), {"axis": 0}),
    ("where", ((M > 0).astype(np.float32), M, -M), {}),
    ("take", (M, IDX), {"axis": 1}),
    ("take", (M, IDX), {"axis": 0, "mode": "wrap"}),
    ("take", (M, IDX[0]), {}),
    ("pick", (M, PICK), {"axis": 1}),
    ("pick", (M, PICK), {"axis": 1, "keepdims": True}),
    ("pick", (M, np.array([0, 3, 1, 2, 0, 1], np.float32)), {"axis": 0}),
    ("gather_nd", (M, NDI), {}),
    ("gather_nd", (X, np.array([[1, 0], [2, 1]], np.int32)), {}),
    ("scatter_nd", (M[0, :2], NDI), {"shape": (4, 6)}),
    ("one_hot", (LENS,), {"depth": 5}),
    ("one_hot", (IDX[0],), {"depth": 4, "on_value": 2.5,
                            "off_value": -1.0}),
    ("diag", (M,), {}),
    ("diag", (M,), {"k": 2}),
    ("diag", (M[0],), {"k": -1}),
    ("zeros_like", (M,), {}),
    ("ones_like", (M,), {}),
    ("full_like", (M,), {"fill_value": 3.5}),
    ("sequence_mask", (SEQ, LENS), {"use_sequence_length": True,
                                    "value": -1.0}),
    ("sequence_mask", (SEQ.transpose(1, 0, 2), LENS),
     {"use_sequence_length": True, "axis": 1}),
    ("sequence_mask", (SEQ,), {}),
    ("sequence_last", (SEQ, LENS), {"use_sequence_length": True}),
    ("sequence_last", (SEQ,), {}),
    ("sequence_reverse", (SEQ, LENS), {"use_sequence_length": True}),
    ("sequence_reverse", (SEQ,), {}),
    ("boolean_mask", (M, (M[:, 0] > 0).astype(np.float32)), {}),
    ("boolean_mask", (M, np.array([0, 1, 1, 0, 1, 0], np.float32)),
     {"axis": 1}),
    ("reshape_like", (M, M.reshape(2, 12)), {}),
    ("reshape_like", (X, M.reshape(12, 2)), {"lhs_begin": 1, "lhs_end": 3,
                                             "rhs_begin": 0, "rhs_end": 1}),
]
_FN = {"slice": "slice_op"}
# the registry names (aliases included) of every op above
_REGISTRY = {"reshape", "Reshape", "transpose", "swapaxes", "SwapAxis",
             "expand_dims", "squeeze", "flatten", "Flatten", "broadcast_to",
             "broadcast_like", "broadcast_axis", "tile", "repeat", "pad",
             "Pad", "stack", "concat", "Concat", "split", "SliceChannel",
             "split_v2", "slice", "slice_axis", "slice_like", "reverse",
             "flip", "where", "take", "pick", "choose_element_0index",
             "gather_nd", "scatter_nd", "one_hot", "diag", "shape_array",
             "size_array", "zeros_like", "ones_like", "full_like",
             "SequenceMask", "SequenceLast", "SequenceReverse",
             "boolean_mask", "reshape_like"}


def _outs(x):
    x = x if isinstance(x, tuple) else (x,)
    return [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o)
            for o in x]


def _equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape,
                                                           g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_equals_the_jax_op(i):
    name, arrays, kw = CASES[i]
    fn = _FN.get(name, name)
    ref = getattr(so_j, fn)(*[jnp.asarray(a) for a in arrays], **kw)
    got = getattr(so_t, fn)(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in arrays], **kw)
    _equal(_outs(got), _outs(ref))


def test_every_jax_op_is_registered_in_the_port():
    from mxnet_tpu import ops as ops_j
    jax_names = {n for n, f in ops_j.OPS.items()
                 if getattr(f, "__module__", "") == so_j.__name__}
    assert jax_names == _REGISTRY
    assert set(so_t.NAMES) == _REGISTRY
    from mxnet_tpu_torch.ndarray.ndarray import OPS
    assert _REGISTRY <= set(OPS)


@pytest.mark.parametrize("name", ["shape_array", "size_array"])
def test_shape_and_size_arrays(name):
    ref = getattr(so_j, name)(jnp.asarray(X))
    got = getattr(so_t, name)(torch.from_numpy(X))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_nd_namespace_and_methods_match_jax():
    xj, xt = nd_j.array(X), nd_t.array(X, ctx=mxt.cpu())
    mj, mt = nd_j.array(M), nd_t.array(M, ctx=mxt.cpu())
    pairs = [
        (nd_j.transpose(xj, axes=(0, 3, 1, 2)),
         nd_t.transpose(xt, axes=(0, 3, 1, 2))),
        (nd_j.stack(mj, mj, axis=1), nd_t.stack(mt, mt, axis=1)),
        (nd_j.concat(mj, mj, dim=1), nd_t.concat(mt, mt, dim=1)),
        (nd_j.Concat(mj, mj, dim=0), nd_t.Concat(mt, mt, dim=0)),
        (xj.swapaxes(1, 2), xt.swapaxes(1, 2)),
        (xj.flip(axis=3), xt.flip(axis=3)),
        (mj.take(nd_j.array(IDX), axis=1), mt.take(nd_t.array(
            IDX, ctx=mxt.cpu()), axis=1)),
        (xj.reshape((0, -1)), xt.reshape((0, -1))),
        (xj.reshape(shape=(6, -1)), xt.reshape(shape=(6, -1))),
        (xj.transpose(), xt.transpose()),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    for j, t in zip(nd_j.split(mj, num_outputs=2, axis=1),
                    nd_t.split(mt, num_outputs=2, axis=1)):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert isinstance(nd_t.SliceChannel(mt, 2), tuple)


@pytest.mark.parametrize("shape,codes,want", [
    ((2, 3, 4), (4, 0, 2), (4, 3, 2)),
    ((2, 3, 4), (2, 0, 0), (2, 3, 4)),
    ((2, 3, 4), (6, 1, -1), (6, 1, 4)),
    ((2, 3, 4), (3, -1, 8), (3, 1, 8)),
    ((2, 3, 4), (-1,), (24,)),
    ((2, 3, 4), (-2,), (2, 3, 4)),
    ((2, 3, 4), (2, -2), (2, 3, 4)),
    ((2, 3, 4), (-2, 1, 1), (2, 3, 4, 1, 1)),
    ((2, 3, 4), (-3, 4), (6, 4)),
    ((2, 3, 4, 5), (-3, -3), (6, 20)),
    ((2, 3, 4), (0, -3), (2, 12)),
    ((2, 3, 4), (-3, -2), (6, 4)),
    ((2, 3, 4), (-4, 1, 2, -2), (1, 2, 3, 4)),
    ((2, 3, 4), (2, -4, -1, 3, -2), (2, 1, 3, 4))])
def test_reshape_codes_of_mxnet(shape, codes, want):
    """MXNet's documented examples of reshape's codes; the data keeps its
    order (a reshape of the flat array)."""
    a = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = so_t.reshape(torch.from_numpy(a), codes)
    assert tuple(got.shape) == want
    np.testing.assert_array_equal(got.numpy(), a.reshape(want))
    t = nd_t.array(a, ctx=mxt.cpu())
    assert t.reshape(codes).shape == want == nd_t.reshape(t, codes).shape


def test_clip_and_wrap_modes():
    a = np.arange(5, dtype=np.float32) * 10
    idx = np.array([-7, -1, 0, 4, 5, 12], np.float32)
    for mode, want in (("clip", [0, 0, 0, 40, 40, 40]),
                       ("wrap", [30, 40, 0, 40, 0, 20])):
        got = so_t.take(torch.from_numpy(a), torch.from_numpy(idx), 0, mode)
        np.testing.assert_array_equal(got.numpy(), np.float32(want))
        ref = so_j.take(jnp.asarray(a), jnp.asarray(idx), 0, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        so_t.take(torch.from_numpy(a), torch.from_numpy(idx), 0, "raise")
    # pick: "clip" reads a negative index from the end first, as
    # jnp.take_along_axis does; "wrap" (which the JAX pick lacks) is MXNet's
    m = np.arange(12, dtype=np.float32).reshape(2, 6)
    pidx = np.array([-7, -2], np.float32)
    got = so_t.pick(torch.from_numpy(m), torch.from_numpy(pidx), 1)
    np.testing.assert_array_equal(got.numpy(), np.float32([0, 10]))
    ref = so_j.pick(jnp.asarray(m), jnp.asarray(pidx), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = so_t.pick(torch.from_numpy(m), torch.from_numpy(pidx), 1,
                    mode="wrap")
    np.testing.assert_array_equal(got.numpy(), np.float32([5, 10]))
