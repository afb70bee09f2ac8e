"""Binary `.params` container compatibility (a copy of
`mxnet_tpu/ndarray/params_io.py`, which needs only numpy; reference:
`NDArray::Save/Load` in `src/ndarray/ndarray.cc` + the list container in
`src/c_api/c_api.cc` MXNDArraySave/MXNDArrayLoad, serialized via
dmlc::Stream). Both packages write and read the same bytes.

Byte layout (little-endian throughout):

container:
    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  n_arrays
    n_arrays x ndarray-record
    uint64  n_names              (0, or == n_arrays)
    n_names x { uint64 len; bytes[len] }

ndarray-record, dense (storage type kDefaultStorage = 0):
    uint32  magic                NDARRAY_V2 = 0xF993FAC9 (uint32 dims)
                                 or NDARRAY_V3 = 0xF993FACA (int64 dims)
    int32   stype                0 = kDefaultStorage (dense; row_sparse=1,
                                 csr=2 are rejected on load)
    uint32  ndim
    ndim x  uint32|int64 dim     (width per magic)
    int32   dev_type (1 = cpu)   } Context::Save
    int32   dev_id   (0)         }
    int32   type_flag            mshadow: 0 f32, 1 f64, 2 f16, 3 u8,
                                 4 i32, 5 i8, 6 i64
    bytes   raw data             shape.prod() * elemsize

Legacy records whose first uint32 is neither magic are the pre-magic V1
layout (shape first, no stype); Load supports them by rewinding.

Save writes V2 when every dim fits uint32, else V3. bf16 has no mshadow
type_flag — such arrays are up-cast to f32 on save (noted here because the
reference ecosystem cannot represent bf16 in this container).
"""
from __future__ import annotations

import struct

import numpy as np

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9
V3_MAGIC = 0xF993FACA

# storage types (include/mxnet/ndarray.h NDArrayStorageType:
# kUndefinedStorage=-1, kDefaultStorage=0, kRowSparseStorage=1, kCSRStorage=2)
STYPE_DENSE = 0

_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
               4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


def _write_ndarray(f, arr):
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _FLAG_OF:
        # bf16 / unsupported dtypes: widen to f32 (documented above)
        arr = arr.astype(np.float32)
    use_v3 = any(d > 0xFFFFFFFF for d in arr.shape)
    f.write(struct.pack("<I", V3_MAGIC if use_v3 else V2_MAGIC))
    f.write(struct.pack("<i", STYPE_DENSE))
    f.write(struct.pack("<I", arr.ndim))
    fmt = "<q" if use_v3 else "<I"
    for d in arr.shape:
        f.write(struct.pack(fmt, d))
    f.write(struct.pack("<ii", 1, 0))                  # Context: cpu(0)
    f.write(struct.pack("<i", _FLAG_OF[arr.dtype]))
    f.write(arr.tobytes())


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated .params stream")
    return b


def _read_ndarray(f):
    (magic,) = struct.unpack("<I", _read_exact(f, 4))
    if magic == V2_MAGIC or magic == V3_MAGIC:
        (stype,) = struct.unpack("<i", _read_exact(f, 4))
        if stype != STYPE_DENSE:
            raise NotImplementedError(
                f"sparse storage type {stype} in .params (dense only)")
        dim_fmt, dim_sz = ("<q", 8) if magic == V3_MAGIC else ("<I", 4)
    elif magic == V1_MAGIC:
        dim_fmt, dim_sz = "<I", 4
    else:
        # legacy pre-magic record: the uint32 we just read IS ndim
        ndim = magic
        if ndim > 32:
            raise ValueError(f"bad .params record (magic 0x{magic:x})")
        return _read_body(f, ndim, "<I", 4)
    (ndim,) = struct.unpack("<I", _read_exact(f, 4))
    return _read_body(f, ndim, dim_fmt, dim_sz)


def _read_body(f, ndim, dim_fmt, dim_sz):
    shape = tuple(struct.unpack(dim_fmt, _read_exact(f, dim_sz))[0]
                  for _ in range(ndim))
    struct.unpack("<ii", _read_exact(f, 8))            # Context (ignored)
    (flag,) = struct.unpack("<i", _read_exact(f, 4))
    if flag not in _TYPE_FLAGS:
        raise ValueError(f"unknown mshadow type_flag {flag}")
    dt = np.dtype(_TYPE_FLAGS[flag])
    n = int(np.prod(shape)) if shape else 1
    data = np.frombuffer(_read_exact(f, n * dt.itemsize), dtype=dt)
    return data.reshape(shape).copy()


def save_params(fname, arrays, names=None):
    """Write the binary container. arrays: list of numpy arrays."""
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_ndarray(f, a)
        names = list(names) if names else []
        f.write(struct.pack("<Q", len(names)))
        for nme in names:
            b = nme.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_params(fname):
    """Read the binary container. Returns (arrays, names) — names [] when
    the file was saved without keys."""
    with open(fname, "rb") as f:
        magic, _reserved = struct.unpack("<QQ", _read_exact(f, 16))
        if magic != LIST_MAGIC:
            raise ValueError(
                f"not an NDArray list container (magic 0x{magic:x})")
        (n,) = struct.unpack("<Q", _read_exact(f, 8))
        arrays = [_read_ndarray(f) for _ in range(n)]
        (nn,) = struct.unpack("<Q", _read_exact(f, 8))
        names = []
        for _ in range(nn):
            (ln,) = struct.unpack("<Q", _read_exact(f, 8))
            names.append(_read_exact(f, ln).decode("utf-8"))
    return arrays, names


def is_params_file(fname):
    """Sniff the 8-byte list magic."""
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and struct.unpack("<Q", head)[0] == LIST_MAGIC
    except OSError:
        return False
