"""Shape-manipulation and indexing ops (counterpart of
`mxnet_tpu/ops/shape_ops.py`), on torch tensors: reshape (with MXNet's
special codes), transpose, swapaxes, expand_dims, squeeze, flatten, the
broadcasts, tile, repeat, pad, stack, concat, split, split_v2, the
slices, reverse, where, take, pick, gather_nd, scatter_nd and one_hot;
then diag, shape_array, size_array, the `*_like` constructors, the
sequence ops, boolean_mask and reshape_like. `NAMES` maps each JAX
registry name (aliases included) to its function here; the op registry
(`ops.OPS`) holds them under those names, for `nd.<name>`,
`NDArray.<name>` and `sym.<name>`.

The ops only move data, except one_hot's arithmetic and where's dtype
promotion, so their outputs equal the JAX ops' bit for bit. `reshape`
takes MXNet's full set of codes (0 copies a dimension, -1 infers one,
-2 copies the rest, -3 merges two, -4 splits one into the next two);
the JAX op takes 0 and -1 only. `take` and `pick` take mode "clip"
(indices clamped into range, as the JAX ops clamp them) and "wrap"
(modulo the axis; the JAX `pick` has no "wrap"). A negative `slice`
step reads the indices Python's `slice` gives.
"""
from __future__ import annotations

import math

import torch

__all__ = ["reshape", "transpose", "swapaxes", "expand_dims", "squeeze",
           "flatten", "broadcast_to", "broadcast_like", "broadcast_axis",
           "tile", "repeat", "pad", "stack", "concat", "split", "split_v2",
           "slice_op", "slice_axis", "slice_like", "reverse", "where",
           "take", "pick", "gather_nd", "scatter_nd", "one_hot", "diag",
           "shape_array", "size_array", "zeros_like", "ones_like",
           "full_like", "sequence_mask", "sequence_last",
           "sequence_reverse", "boolean_mask", "reshape_like", "NAMES"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def _reshape_target(shape, dshape):
    """The output shape of MXNet's reshape codes over input dims dshape
    (reference: `src/operator/tensor/matrix_op-inl.h` InferReshapeShape)."""
    out, src, infer, i = [], 0, None, 0
    while i < len(shape):
        s = int(shape[i])
        if s == 0:
            out.append(dshape[src])
            src += 1
        elif s == -1:
            infer = len(out)
            out.append(1)
            src += 1
        elif s == -2:
            out.extend(dshape[src:])
            src = len(dshape)
        elif s == -3:
            out.append(dshape[src] * dshape[src + 1])
            src += 2
        elif s == -4:
            d0, d1, d2 = dshape[src], int(shape[i + 1]), int(shape[i + 2])
            if d1 == -1:
                d1 = d0 // d2
            if d2 == -1:
                d2 = d0 // d1
            if d1 * d2 != d0:
                raise ValueError(f"reshape: -4 splits {d0} into {d1} x {d2}")
            out += [d1, d2]
            src += 1
            i += 2
        else:
            out.append(s)
            src += 1
        i += 1
    if infer is not None:
        known = math.prod(d for j, d in enumerate(out) if j != infer)
        out[infer] = math.prod(dshape) // max(known, 1)
    return tuple(out)


def reshape(data, shape=None):
    if shape is None:
        return data
    return data.reshape(_reshape_target(tuple(shape), tuple(data.shape)))


def transpose(data, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


def expand_dims(data, axis):
    return data.unsqueeze(axis)


def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if data.shape[a] != 1:
            raise ValueError(f"squeeze: axis {a} has size {data.shape[a]}, "
                             "not 1")
    return data.squeeze(axes)


def flatten(data):
    return data.reshape(data.shape[0], -1)


def broadcast_to(data, shape):
    shape = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, shape)


def broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


def broadcast_axis(data, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(data, tuple(shape))


def tile(data, reps):
    return torch.tile(data, (reps,) if isinstance(reps, int) else tuple(reps))


def repeat(data, repeats, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


def _pad_index(n, before, after, mode, device):
    """Source positions along one axis of length n after padding
    `before`/`after` by edge replication or reflection (numpy's
    'reflect': the edge element is not repeated)."""
    pos = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return pos.clamp(0, n - 1)
    period = 2 * (n - 1)
    pos = pos.remainder(period)
    return torch.where(pos < n, pos, period - pos)


def pad(data, mode="constant", pad_width=None, constant_value=0.0):
    """MXNet's pad: pad_width is flat (before0, after0, before1, ...)."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)
    if mode == "constant":
        flat = [v for b, a in reversed(pw) for v in (b, a)]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    out = data
    for axis, (b, a) in enumerate(pw):
        if b or a:
            out = out.index_select(axis, _pad_index(out.shape[axis], b, a,
                                                    mode, data.device))
    return out


def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


def _equal_parts(data, n, axis):
    size = data.shape[axis]
    if size % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {size} into {n}")
    return torch.split(data, size // n, dim=axis)


def split(data, num_outputs, axis=1, squeeze_axis=False):
    parts = _equal_parts(data, num_outputs, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """2.x-style split: an int gives equal sections, a sequence the split
    indices (uneven parts allowed)."""
    if isinstance(indices_or_sections, int):
        parts = _equal_parts(data, indices_or_sections, axis)
    else:
        parts = torch.tensor_split(data, list(indices_or_sections), dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def slice_op(data, begin, end, step=None):
    step = step or [None] * len(begin)
    out = data
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        sl = slice(b, e, s)
        if s is None or s > 0:
            idx = [slice(None)] * out.dim()
            idx[axis] = sl
            out = out[tuple(idx)]
        else:
            keep = range(*sl.indices(out.shape[axis]))
            out = out.index_select(axis, torch.tensor(
                list(keep), dtype=torch.int64, device=out.device))
    return out


def slice_axis(data, axis, begin, end):
    if end is None:
        end = data.shape[axis]
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


def slice_like(data, shape_like, axes=()):
    axes = axes or tuple(range(min(data.dim(), shape_like.dim())))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


def reverse(data, axis):
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(data, dims=tuple(axis))


def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


def _index(indices, n, mode):
    """int64 indices into an axis of length n, clipped or wrapped."""
    idx = indices.to(torch.int64)
    if mode == "clip":
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return idx.remainder(n)
    raise ValueError(f"index mode {mode!r} (clip or wrap)")


def take(a, indices, axis=0, mode="clip"):
    axis = axis % a.dim()
    idx = _index(indices, a.shape[axis], mode)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """Along `axis`, the element `index` names. In "clip" mode a negative
    index counts from the end first, as `jnp.take_along_axis` reads it
    (`take` clamps it to 0, as `jnp.take` does)."""
    n = data.shape[axis]
    if mode == "clip":
        index = index.to(torch.int64)
        index = torch.where(index < 0, index + n, index)
    idx = _index(index, n, mode).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def gather_nd(data, indices):
    """indices (M, ...): its leading dim indexes the first M axes."""
    return data[tuple(indices.to(torch.int64))]


def scatter_nd(data, indices, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    out[tuple(indices.to(torch.int64))] = data
    return out


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    ind = indices.to(torch.int32)
    oh = (ind[..., None] == torch.arange(depth, device=ind.device)).to(
        _DTYPES[str(dtype)])
    return oh * on_value + (1.0 - oh) * off_value


def diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64, device=data.device)


def zeros_like(data):
    return torch.zeros_like(data)


def ones_like(data):
    return torch.ones_like(data)


def full_like(data, fill_value):
    return torch.full_like(data, fill_value)


# -- sequence ops (reference: `src/operator/sequence_*.cc`); MXNet layout
# (seq_len, batch, ...) unless `axis` says otherwise --------------------------

def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    seq_axis = axis if axis in (0, 1) else 0
    lens = sequence_length.to(device=data.device, dtype=torch.int32)
    mask = (torch.arange(data.shape[seq_axis], device=data.device)[:, None]
            < lens[None, :])
    if seq_axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.to(device=data.device, dtype=torch.int64) - 1
    moved = torch.movedim(data, axis, 0)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)
    L = moved.shape[0]
    lens = sequence_length.to(device=data.device, dtype=torch.int64)[None, :]
    pos = torch.arange(L, device=data.device)[:, None]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2)).expand(
        moved.shape)
    return torch.movedim(torch.gather(moved, 0, src), 0, axis)


def boolean_mask(data, index, axis=0):
    """The selected rows first, in order, then zeros: the JAX op's static
    shape (the reference compacts)."""
    mask = index.to(torch.bool)
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    gathered = data.index_select(axis, order)
    keep = torch.sort(mask.to(torch.int8), descending=True).values
    shape = [1] * data.dim()
    shape[axis] = -1
    return gathered * keep.reshape(shape).to(data.dtype)


def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """Reshape lhs into rhs's shape, or a range of lhs's axes into a
    range of rhs's (reference: tensor/matrix_op.cc reshape_like)."""
    if lhs_begin is None and rhs_begin is None and lhs_end is None \
            and rhs_end is None:
        return lhs.reshape(rhs.shape)
    lb = int(lhs_begin or 0)
    le = lhs.dim() if lhs_end is None else int(lhs_end)
    rb = int(rhs_begin or 0)
    re_ = rhs.dim() if rhs_end is None else int(rhs_end)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


# the JAX registry's names (aliases included) -> function name here
NAMES = {
    "reshape": "reshape", "Reshape": "reshape", "transpose": "transpose",
    "swapaxes": "swapaxes", "SwapAxis": "swapaxes",
    "expand_dims": "expand_dims", "squeeze": "squeeze", "flatten": "flatten",
    "Flatten": "flatten",
    "broadcast_to": "broadcast_to", "broadcast_like": "broadcast_like",
    "broadcast_axis": "broadcast_axis", "tile": "tile", "repeat": "repeat",
    "pad": "pad", "Pad": "pad", "stack": "stack", "concat": "concat",
    "Concat": "concat", "split": "split", "SliceChannel": "split",
    "split_v2": "split_v2", "slice": "slice_op", "slice_axis": "slice_axis",
    "slice_like": "slice_like", "reverse": "reverse", "flip": "reverse",
    "where": "where", "take": "take", "pick": "pick",
    "choose_element_0index": "pick",
    "gather_nd": "gather_nd", "scatter_nd": "scatter_nd",
    "one_hot": "one_hot", "diag": "diag", "shape_array": "shape_array",
    "size_array": "size_array", "zeros_like": "zeros_like",
    "ones_like": "ones_like", "full_like": "full_like",
    "SequenceMask": "sequence_mask", "SequenceLast": "sequence_last",
    "SequenceReverse": "sequence_reverse", "boolean_mask": "boolean_mask",
    "reshape_like": "reshape_like"}
