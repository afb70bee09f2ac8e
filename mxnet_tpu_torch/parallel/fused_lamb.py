"""Fused multi-tensor LAMB with float32 master weights (counterpart of
`mxnet_tpu/parallel/fused_lamb.py`).

The master weights and both moments live as ONE flat vector each, every
parameter a segment padded to a whole number of 512-lane rows (zeros in
the padding, which every derived quantity keeps at zero). The master is
float32; the moments are float32, or bfloat16 when `moments_dtype` says
so (the `lamb_moments_dtype` knob, which the trainer reads): the math
stays float32, and the stored moments round through bf16 before the
trust-ratio norms (`cuda_ops.fused_update`). The JAX package's kernels
pad the rows to 16 for bf16's sublane tiles; this layout needs no such
padding, so both dtypes keep the same R.
The train step runs the model on `unflatten(master)`, per-tensor views
cast to the model dtype whose backward scatters each gradient into one
flat float32 vector, so the optimizer receives the gradient already flat.
`apply_flat` is two passes over the (rows, 512) view
(`cuda_ops.fused_update`: hand-written kernels on the card, plain torch
on the CPU); between them, the per-segment norms and the trust ratio.
A segment's norm sums its per-row sums of squares in a fixed order: the
rows gathered into chunks of `_SEG_ROWS` rows of one segment (zeros
padding a chunk) and each chunk summed, then each segment's chunk sums
gathered and summed the same way. Never a scatter-add (`index_add_` adds
with float atomics on the card, in another order every run, so two runs
of one step gave other trust ratios in their last bits) and never a
cumsum difference (float32 cancellation on ~1e8-sized prefixes loses
small segments, and a zero segment need not come out exactly 0).
"""
from __future__ import annotations

import numpy as np
import torch

from ..cuda_ops import fused_update as _fu

__all__ = ["FusedLamb"]

_CHUNK = _fu.LANES
_SEG_ROWS = 256          # rows (then chunks) summed together in a segment
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gather_table(lengths, width, pad):
    """(len(lengths), width) int64 indices: row i lists the consecutive
    ids lengths[:i].sum() ... + lengths[i] - 1, then `pad`."""
    starts = np.cumsum([0] + list(lengths[:-1]))
    table = np.full((len(lengths), width), pad, np.int64)
    for i, (a, n) in enumerate(zip(starts, lengths)):
        table[i, :n] = np.arange(a, a + n)
    return table


class _Unflatten(torch.autograd.Function):
    """flat float32 -> per-tensor views in the model dtypes; the backward
    writes each incoming gradient into its segment of ONE flat float32
    gradient (padding stays zero)."""

    @staticmethod
    def forward(ctx, flat, layout):
        ctx.layout = layout
        ctx.total, ctx.device = flat.numel(), flat.device
        # a float32 view is copied: a custom Function hands out no views
        # of its input
        return tuple(
            flat[off:off + n].view(shape).to(dt, copy=True)
            for off, n, shape, dt in layout)

    @staticmethod
    def backward(ctx, *grads):
        g = torch.zeros(ctx.total, dtype=torch.float32, device=ctx.device)
        for (off, n, _, _), gi in zip(ctx.layout, grads):
            if gi is not None:
                g[off:off + n].copy_(gi.reshape(-1))
        return g, None


class FusedLamb:
    """Precomputed flat layout + the two-pass fused LAMB update."""

    def __init__(self, shapes, dtypes, wds, beta1, beta2, epsilon,
                 bias_correction, rescale_grad, clip_gradient,
                 lower_bound, upper_bound, moments_dtype=torch.float32):
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.moments_dtype = _MOMENT_DTYPES.get(moments_dtype, moments_dtype)
        if self.moments_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"FusedLamb: moments_dtype {moments_dtype!r} is "
                             "not float32 or bfloat16")
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.bias_correction = bias_correction
        self.rescale = rescale_grad
        self.clip = clip_gradient
        self.lo, self.hi = lower_bound, upper_bound

        sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        padded = [(n + _CHUNK - 1) // _CHUNK * _CHUNK for n in sizes]
        self.sizes = sizes
        self.offsets = np.cumsum([0] + padded).tolist()
        self.total = self.offsets[-1]
        self.n_rows = self.total // _CHUNK
        # row r belongs to segment row_seg[r]; segments are whole row ranges
        row_seg = np.zeros(self.n_rows, np.int64)
        for i, (off, pad) in enumerate(zip(self.offsets[:-1], padded)):
            row_seg[off // _CHUNK: (off + pad) // _CHUNK] = i
        self.row_seg = torch.from_numpy(row_seg)
        # the segment sum's two gathers: each segment's rows in chunks of
        # _SEG_ROWS (row id n_rows is a zero), then each segment's chunks
        # (chunk id n_chunks is a zero)
        seg_rows = [p // _CHUNK for p in padded]
        chunk_rows, seg_chunks = [], []
        for r in seg_rows:
            k = max(1, -(-r // _SEG_ROWS))
            chunk_rows += [min(_SEG_ROWS, r - j * _SEG_ROWS)
                           for j in range(k)]
            seg_chunks.append(k)
        self._seg_tables = (
            torch.from_numpy(_gather_table(chunk_rows, _SEG_ROWS,
                                           self.n_rows)),
            torch.from_numpy(_gather_table(seg_chunks, max(seg_chunks,
                                                           default=1),
                                           len(chunk_rows))))
        self.wd_seg = torch.tensor(np.asarray(wds, np.float32))
        self._layout = [(off, n, s, dt) for off, n, s, dt in zip(
            self.offsets[:-1], sizes, self.shapes, self.dtypes)]
        self._on = {}

    def _rows(self, device):
        """(row_seg, wd_rows, the segment sum's gather tables) on
        `device`, cached."""
        key = str(device)
        if key not in self._on:
            row_seg = self.row_seg.to(device)
            self._on[key] = (row_seg, self.wd_seg.to(device)[row_seg],
                             tuple(t.to(device) for t in self._seg_tables))
        return self._on[key]

    @staticmethod
    def _segment_sum(rows, tables):
        """Per-segment sums of the (R,) per-row values, in a fixed order:
        chunk sums of each segment's rows, then sums of its chunks."""
        for table in tables:
            rows = torch.cat([rows, rows.new_zeros(1)])[table].sum(1)
        return rows

    # -- flat <-> per-param ---------------------------------------------
    def flatten(self, arrs):
        """One flat float32 vector (on the first tensor's device) of the
        tensors `arrs`, each padded to whole rows."""
        if not arrs:
            return torch.zeros(0)
        out = torch.zeros(self.total, device=arrs[0].device)
        self.load_flat(out, [a.detach() for a in arrs])
        return out

    def load_flat(self, flat, arrs):
        """Copy the per-tensor `arrs` (any device and dtype) into their
        segments of the resident flat vector `flat`, in place (its
        padding stays zero)."""
        for a, off, n in zip(arrs, self.offsets[:-1], self.sizes):
            flat[off:off + n].copy_(a.reshape(-1))

    def zeros_moments(self, device):
        """Two zero flat moment vectors in the moments' dtype."""
        return tuple(torch.zeros(self.total, dtype=self.moments_dtype,
                                 device=device) for _ in range(2))

    def unflatten(self, flat):
        """Per-tensor model-dtype tensors of the flat master,
        differentiable: the gradient of a loss over them arrives FLAT
        (one float32 vector in the master's layout)."""
        return list(_Unflatten.apply(flat, self._layout))

    def unflatten_master(self, flat):
        """Per-tensor views WITHOUT the model-dtype cast, in the flat
        vector's dtype (the checkpoint layout of master weights and
        moments)."""
        return [flat[off:off + n].view(shape)
                for off, n, shape in zip(self.offsets[:-1], self.sizes,
                                         self.shapes)]

    # -- the fused step --------------------------------------------------
    def apply_flat(self, w, g, m, v, t, lr):
        """One LAMB step at update count t (>= 1) and learning rate lr on
        the flat state (w float32, m and v in the moments' dtype). w, m and
        v update IN PLACE (the JAX package donated them and wrote new
        buffers); g is the flat float32 gradient. Returns (w, m, v)."""
        R, C = self.n_rows, _CHUNK
        W, G = w.view(R, C), g.view(R, C)
        M, V = m.view(R, C), v.view(R, C)
        c1 = (1 - self.b1 ** t) if self.bias_correction else 1.0
        c2 = (1 - self.b2 ** t) if self.bias_correction else 1.0
        row_seg, wd_rows, tables = self._rows(w.device)
        rw, ru = _fu.lamb_pass1(
            W, G, M, V, wd_rows, c1, c2, beta1=self.b1, beta2=self.b2,
            epsilon=self.eps, rescale_grad=self.rescale,
            clip_gradient=self.clip, bias_correction=self.bias_correction)

        r1 = self._segment_sum(rw, tables).sqrt()
        r2 = self._segment_sum(ru, tables).sqrt()
        # zero norms become 1 BEFORE the ratio (lamb_update_phase2), so a
        # zero-init parameter gets trust = 1/||u||
        r1 = torch.where(r1 > 0, r1, 1.0)
        r2 = torch.where(r2 > 0, r2, 1.0)
        trust = r1 / r2
        if self.lo and self.lo > 0:
            trust = torch.clamp(trust, min=self.lo)
        if self.hi and self.hi > 0:
            trust = torch.clamp(trust, max=self.hi)
        _fu.lamb_pass2(W, M, V, wd_rows, trust[row_seg].contiguous(), c1, c2,
                       lr, epsilon=self.eps,
                       bias_correction=self.bias_correction)
        return w, m, v
