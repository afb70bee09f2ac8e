"""Sparse NDArrays: row_sparse and csr storage (counterpart of
`mxnet_tpu/ndarray/sparse.py`; reference: `python/mxnet/ndarray/sparse.py`,
`kRowSparseStorage` / `kCSRStorage`, `src/operator/tensor/cast_storage-inl.h`).

As in the JAX package, sparsity is a storage format, not a kernel
format: the compressed tensors (values and indices, with indptr for
csr) live on the array's device as ordinary tensors, the sparse compute
that matters (row scatter to dense, csr x dense, the row-wise union of
`add`) is plain torch over them, and everything else densifies
explicitly through `tostype('default')`. Host-side index bookkeeping
(the nonzero scan of `cast_storage`, unions, `retain`) runs in numpy at
the imperative boundary, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import NDArray, _torch_dtype, _unwrap
from .ndarray import array as _dense_array

__all__ = [
    "BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
    "row_sparse_array", "csr_matrix", "zeros", "empty", "array",
    "dot", "add", "retain", "cast_storage",
]


def _as_tensor(x, dtype=None, device=None):
    t = x._t if isinstance(x, NDArray) else torch.as_tensor(np.asarray(x))
    if device is not None:
        t = t.to(device)
    return t.to(_torch_dtype(dtype)) if dtype is not None else t


def _host(t):
    return t.detach().cpu().numpy()


class BaseSparseNDArray(NDArray):
    """Common behaviour of the compressed arrays. The dense tensor `_t`
    is unused: a dense op goes through `tostype('default')` explicitly,
    as the reference's storage-type dispatch refuses dense kernels on
    sparse inputs."""

    __slots__ = ("_values", "_indices", "_shape")

    def __init__(self, values, indices, shape):
        super().__init__(None)
        self._values = values
        self._indices = indices
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return NDArray(self._values).dtype

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def data(self):
        """The non-zero values."""
        return NDArray(self._values)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def nnz(self):
        return int(self._values.shape[0]) if self._values.dim() else 0

    @property
    def context(self):
        from ..context import Context
        return Context.of(self._values.device)

    ctx = context

    def wait_to_read(self):
        NDArray(self._values).wait_to_read()
        return self

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype, copy=True):
        out = self.copy()
        out._values = out._values.to(_torch_dtype(dtype))
        return out

    def copyto(self, other):
        if isinstance(other, BaseSparseNDArray):
            other._values = self._values
            other._indices = self._indices
            other._shape = self._shape
            return other
        if isinstance(other, NDArray):
            other._t = self.todense()._t
            return other
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def todense(self):
        return self.tostype("default")

    def __repr__(self):
        return (f"\n<{type(self).__name__} {'x'.join(map(str, self._shape))} "
                f"nnz={self.nnz} @{self.context}>")

    def __getattr__(self, name):
        raise AttributeError(
            f"{type(self).__name__} does not support dense op '{name}'; "
            f"call .tostype('default') first")

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            out = self.copy()
            out._values = out._values * other
            return out
        return NDArray(self.todense()._t * _as_tensor(other))

    __rmul__ = __mul__


class RowSparseNDArray(BaseSparseNDArray):
    """Rows-compressed tensor: `values[i]` holds row `indices[i]` of the
    logical array; every other row is zero (the gradient format of
    Embedding and take)."""

    @property
    def stype(self):
        return "row_sparse"

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            dense = torch.zeros(self._shape, dtype=self._values.dtype,
                                device=self._values.device)
            if self.nnz:
                dense[self._indices.long()] = self._values
            return NDArray(dense)
        if stype == "csr":
            raise ValueError("row_sparse -> csr cast is not defined "
                             "(matches reference cast_storage)")
        raise ValueError(f"unknown stype {stype!r}")

    def retain(self, row_ids):
        """Keep only the rows whose index appears in `row_ids`."""
        rids = np.asarray(_host(_as_tensor(row_ids))).astype(np.int32).ravel()
        cur = _host(self._indices)
        mask = np.isin(cur, rids)
        keep = torch.as_tensor(np.nonzero(mask)[0], device=self._values.device)
        return RowSparseNDArray(self._values[keep],
                                torch.as_tensor(cur[mask]).to(
                                    self._values.device), self._shape)

    def copy(self):
        return RowSparseNDArray(self._values, self._indices, self._shape)


class CSRNDArray(BaseSparseNDArray):
    """Compressed-sparse-row matrix: indptr and indices over a flat
    values array."""

    __slots__ = ("_indptr",)

    def __init__(self, values, indices, indptr, shape):
        super().__init__(values, indices, shape)
        self._indptr = indptr

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._indptr)

    def _rows(self):
        counts = np.diff(_host(self._indptr))
        return torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                               device=self._values.device)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            dense = torch.zeros(self._shape, dtype=self._values.dtype,
                                device=self._values.device)
            if self.nnz:
                dense[self._rows(), self._indices.long()] = self._values
            return NDArray(dense)
        if stype == "row_sparse":
            return cast_storage(self.tostype("default"), "row_sparse")
        raise ValueError(f"unknown stype {stype!r}")

    def asscipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((_host(self._values), _host(self._indices),
                              _host(self._indptr)), shape=self._shape)

    def __getitem__(self, key):
        indptr = _host(self._indptr)
        if isinstance(key, int):
            lo, hi = int(indptr[key]), int(indptr[key + 1])
            row = torch.zeros((self._shape[1],), dtype=self._values.dtype,
                              device=self._values.device)
            if hi > lo:
                row[self._indices[lo:hi].long()] = self._values[lo:hi]
            return NDArray(row)
        if isinstance(key, slice):
            start, stop, step = key.indices(self._shape[0])
            if step != 1:
                raise ValueError("csr slicing requires step 1")
            lo, hi = int(indptr[start]), int(indptr[stop])
            new_indptr = torch.as_tensor(
                indptr[start:stop + 1] - indptr[start],
                device=self._values.device)
            return CSRNDArray(self._values[lo:hi], self._indices[lo:hi],
                              new_indptr, (stop - start, self._shape[1]))
        raise TypeError("csr supports int/slice row indexing only")

    def copy(self):
        return CSRNDArray(self._values, self._indices, self._indptr,
                          self._shape)

    def copyto(self, other):
        if isinstance(other, CSRNDArray):
            other._indptr = self._indptr
        return super().copyto(other)


# -- constructors -----------------------------------------------------------

def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) or from a dense source."""
    if isinstance(arg, RowSparseNDArray):
        return arg.copy()
    if isinstance(arg, tuple) and len(arg) == 2:
        dense_like = _dense_array(arg[0], ctx=ctx, dtype=dtype)._t
        indices = _as_tensor(arg[1]).to(torch.int32)
        if shape is None:
            nrows = int(indices.max()) + 1 if indices.shape[0] else 0
            shape = (nrows,) + tuple(dense_like.shape[1:])
        order = torch.as_tensor(np.argsort(_host(indices), kind="stable"))
        return RowSparseNDArray(dense_like[order.to(dense_like.device)],
                                indices[order].to(dense_like.device), shape)
    return cast_storage(_dense_array(arg, ctx=ctx, dtype=dtype),
                        "row_sparse")


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr), a scipy csr matrix, or a
    dense source."""
    if isinstance(arg, CSRNDArray):
        return arg.copy()
    if isinstance(arg, tuple) and len(arg) == 3:
        values = _dense_array(arg[0], ctx=ctx, dtype=dtype)._t
        indices = _as_tensor(arg[1], device=values.device).to(torch.int32)
        indptr = _as_tensor(arg[2], device=values.device).to(torch.int32)
        if shape is None:
            ncols = int(indices.max()) + 1 if indices.shape[0] else 0
            shape = (int(indptr.shape[0]) - 1, ncols)
        return CSRNDArray(values, indices, indptr, shape)
    try:
        import scipy.sparse as sp
        if sp.issparse(arg):
            csr = arg.tocsr()
            values = _dense_array(csr.data, ctx=ctx, dtype=dtype)._t
            return CSRNDArray(
                values, torch.as_tensor(csr.indices.astype(np.int32),
                                        device=values.device),
                torch.as_tensor(csr.indptr.astype(np.int32),
                                device=values.device), csr.shape)
    except ImportError:
        pass
    return cast_storage(_dense_array(arg, ctx=ctx, dtype=dtype), "csr")


def zeros(stype, shape, ctx=None, dtype="float32"):
    from .. import context
    if isinstance(shape, int):
        shape = (shape,)
    dt, dev = _torch_dtype(dtype), context.resolve(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise ValueError(f"unknown stype {stype!r}")


empty = zeros


def array(source, ctx=None, dtype=None):
    """The sparse-aware `nd.sparse.array`: a scipy matrix or a sparse
    NDArray."""
    try:
        import scipy.sparse as sp
        if sp.issparse(source):
            return csr_matrix(source, ctx=ctx, dtype=dtype)
    except ImportError:
        pass
    if isinstance(source, BaseSparseNDArray):
        return source.copy()
    raise ValueError("use row_sparse_array/csr_matrix for raw tuples")


# -- sparse ops -------------------------------------------------------------

def cast_storage(arr, stype):
    """Dense <-> sparse conversion, on the array's device."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    t = _unwrap(arr)
    if not isinstance(t, torch.Tensor):
        t = _dense_array(t)._t
    if stype == "default":
        return NDArray(t)
    if stype == "row_sparse":
        rows = np.nonzero(_host(t.reshape(t.shape[0], -1) != 0).any(1))[0]
        idx = torch.as_tensor(rows, device=t.device)
        return RowSparseNDArray(t[idx], idx.to(torch.int32), t.shape)
    if stype == "csr":
        if t.dim() != 2:
            raise ValueError("csr requires 2-D input")
        import scipy.sparse as sp
        csr = sp.csr_matrix(_host(t))
        return CSRNDArray(
            torch.as_tensor(csr.data, device=t.device).to(t.dtype),
            torch.as_tensor(csr.indices.astype(np.int32), device=t.device),
            torch.as_tensor(csr.indptr.astype(np.int32), device=t.device),
            tuple(t.shape))
    raise ValueError(f"unknown stype {stype!r}")


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot: csr x dense and csr.T x dense give dense (a
    scatter-add of the nonzeros' products); a row_sparse operand is
    densified first."""
    if isinstance(lhs, CSRNDArray):
        if transpose_b:
            raise ValueError("dot(csr, dense, transpose_b=True) unsupported "
                             "(matches reference)")
        r = _as_tensor(rhs)
        rows, cols = lhs._rows(), lhs._indices.long()
        out_rows, in_rows = (cols, rows) if transpose_a else (rows, cols)
        n_out = lhs.shape[1] if transpose_a else lhs.shape[0]
        prod = lhs._values[:, None].to(r.dtype) * r[in_rows]
        out = torch.zeros((n_out,) + tuple(r.shape[1:]), dtype=r.dtype,
                          device=r.device)
        return NDArray(out.index_add_(0, out_rows, prod))
    if isinstance(lhs, RowSparseNDArray) or isinstance(rhs, BaseSparseNDArray):
        a = (lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs)
        b = (rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs)
        a, b = _as_tensor(a), _as_tensor(b)
        return NDArray((a.T if transpose_a else a) @ (b.T if transpose_b
                                                      else b))
    from .ndarray import registry_op
    return registry_op("dot")(lhs, rhs, transpose_a=transpose_a,
                              transpose_b=transpose_b)


def add(lhs, rhs):
    """Elementwise add with storage dispatch: two row_sparse arrays give a
    row_sparse one over the union of their rows; anything else is
    dense."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise ValueError("shape mismatch")
        li, ri = _host(lhs._indices), _host(rhs._indices)
        union = np.union1d(li, ri)
        dev = lhs._values.device
        dt = torch.promote_types(lhs._values.dtype, rhs._values.dtype)
        vals = torch.zeros((len(union),) + lhs.shape[1:], dtype=dt,
                           device=dev)
        for idx, v in ((li, lhs._values), (ri, rhs._values)):
            if len(idx):
                pos = torch.as_tensor(np.searchsorted(union, idx),
                                      device=dev)
                vals.index_add_(0, pos, v.to(dt))
        return RowSparseNDArray(vals, torch.as_tensor(
            union.astype(np.int32), device=dev), lhs.shape)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return NDArray(_as_tensor(a) + _as_tensor(b))


def retain(arr, indices):
    if not isinstance(arr, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    return arr.retain(indices)
