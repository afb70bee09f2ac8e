"""Post-training int8 quantization (counterpart of
`mxnet_tpu/contrib/quantization.py`).

Symmetric int8 with float32 scales: `QuantizedDense` stores the weight as
int8 with one scale per output channel and runs its product through
`cuda_ops.int8_matmul` (the hand-written tensor-core kernel on the card,
its plain version on the CPU) with the rescale, bias and relu fused.
Beside the (K, O) parameter it keeps the (O, K) K-major copy that the
card's int8 wgmma route reads, as a non-persistent buffer (not a
parameter, so names and shapes stay the JAX package's), re-derived
whenever `weight_q` changes.
The activation is quantized on the fly: with a calibrated static scale
(float32) when `quantize_block` was given calibration batches, else with
a dynamic per-call scale max(|x|)/127 kept in the activation's dtype and
on the device. `quantize_block` swaps every `nn.Dense` of a block for its
int8 twin. Weight quantization runs in numpy exactly as in the JAX
package, so the int8 weights and scales are bit-identical to its own for
the same float weights; the parameter paths are its paths
(`...qkv.weight_q`, `...qkv.weight_scale`, `...qkv.bias`).

`QuantizedConv2D`, `quantize_model` and `quantize_symbol_model` need
`Conv2D` and the symbol layer, which the port does not have yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cuda_ops.int8_matmul import int8_matmul
from ..gluon import nn as _nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Constant

__all__ = ["quantize_params", "QuantizedDense", "quantize_block",
           "CalibrationCollector", "INT8_MAX"]

INT8_MAX = 127.0


def _scale_for(arr_np, mode="naive", percentile=99.99):
    a = np.abs(np.asarray(arr_np, np.float32)).ravel()
    if a.size == 0:
        return 1.0
    if mode == "entropy":
        amax = float(np.percentile(a, percentile))
    else:
        amax = float(a.max())
    return (amax / INT8_MAX) if amax > 0 else 1.0


def _numpy_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def quantize_params(weight, mode="naive"):
    """float weight -> (int8 weight, float per-tensor scale), numpy."""
    w = _numpy_f32(weight)
    scale = _scale_for(w, mode)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _per_channel_scales(w2d, mode, percentile=99.99):
    """Per-output-channel symmetric int8 scales for a (O, -1) weight
    view."""
    amax = np.abs(w2d).max(axis=1)
    if mode == "entropy":
        amax = np.minimum(amax, np.percentile(np.abs(w2d), percentile,
                                              axis=1))
    return np.where(amax > 0, amax / INT8_MAX, 1.0).astype(np.float32)


class QuantizedDense(HybridBlock):
    """Int8-weight Dense for inference: per-output-channel weight scales,
    the activation quantized with a calibrated static scale when given,
    else a dynamic per-call scale.

    `simulate=True` keeps the same int8 weights but dequantizes them and
    runs the float product on the float activation: the reference model
    that the int8 serving path's token-identity gate compares against."""

    def __init__(self, dense, act_scale=None, mode="naive", simulate=False):
        super().__init__()
        act = getattr(dense, "_act", None)
        if act not in (None, "relu"):
            raise NotImplementedError(
                f"QuantizedDense: fused activation '{act}' not supported "
                "(relu only)")
        self._act = act
        dev = dense.weight.device
        w = _numpy_f32(dense.weight)                               # (O, I)
        w_scale = _per_channel_scales(w, mode)
        w_q = np.clip(np.round(w / w_scale[:, None]), -127, 127
                      ).astype(np.int8)
        # pre-transposed (K, O), the JAX package's layout
        self.weight_q = Constant(
            "weight_q", torch.from_numpy(np.ascontiguousarray(w_q.T)).to(dev))
        self.weight_scale = Constant("weight_scale",
                                     torch.from_numpy(w_scale).to(dev))
        # the K-major (O, K) copy for the card's M > 16 route
        self.register_buffer("weight_q_k", torch.from_numpy(w_q).to(dev),
                             persistent=False)
        self._weight_q_k_of = self._weight_q_key()
        self.bias = None
        if dense.bias is not None:
            self.bias = Constant("bias", torch.from_numpy(
                _numpy_f32(dense.bias)).to(dev))
        self._act_scale = act_scale            # None -> dynamic
        self._simulate = bool(simulate)
        # the divisors of the activation quantization as 0-d device
        # tensors: dividing by one is a true division on the card too (CUDA
        # turns a division by a host scalar into a multiply by its rounded
        # reciprocal, which is not the JAX package's arithmetic)
        self.register_buffer("_int8_max", torch.full(
            (), INT8_MAX, dtype=dense.weight.dtype, device=dev),
            persistent=False)
        if act_scale is not None:
            self.register_buffer("_x_scale", torch.full(
                (), float(np.float32(act_scale)), dtype=torch.float32,
                device=dev), persistent=False)

    def _weight_q_key(self):
        w = self.weight_q
        return w.data_ptr(), w._version, w.device

    def kmajor_weight(self):
        """`weight_q` as a contiguous (O, K) int8 tensor: the buffer,
        transposed anew when `weight_q` was written (an in-place copy such
        as `weights.load_named_arrays` bumps its version) or moved."""
        key = self._weight_q_key()
        if key != self._weight_q_k_of:
            self.weight_q_k = self.weight_q.detach().t().contiguous()
            self._weight_q_k_of = key
        return self.weight_q_k

    def forward(self, x):
        relu = self._act == "relu"
        if self._simulate:
            w = self.weight_q.float() * self.weight_scale[None, :]
            out = x.float() @ w
            if self.bias is not None:
                out = out + self.bias
            if relu:
                out = torch.relu(out)
            return out.to(x.dtype)
        if self._act_scale is not None:
            # a float32 scale: the division runs in float32
            s_x = self._x_scale
            xs = x.float() / s_x
        else:
            # the dynamic scale stays in the activation's dtype
            amax = torch.clamp(x.abs().amax(), min=1e-8)
            s_x = amax / self._int8_max.to(x.dtype)
            xs = x / s_x
        x_q = torch.clamp(torch.round(xs), -127, 127).to(torch.int8)
        out = int8_matmul(x_q, self.weight_q, s_x, self.weight_scale,
                          bias=self.bias, relu=relu,
                          w_q_k=self.kmajor_weight())
        return out.to(x.dtype)


class CalibrationCollector:
    """Per-layer activation ranges from sample batches (calib_mode
    'naive': the running max of |x|)."""

    def __init__(self, mode="naive"):
        self.mode = mode
        self.ranges = {}

    def collect(self, name, arr):
        self.ranges[name] = max(self.ranges.get(name, 0.0),
                                float(arr.detach().abs().max()))

    def scale(self, name):
        r = self.ranges.get(name)
        return (r / INT8_MAX) if r else None


def _walk(block, prefix=""):
    for name, child in list(block.named_children()):
        yield block, name, child, f"{prefix}{name}"
        yield from _walk(child, f"{prefix}{name}.")


def _on_device(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device) if isinstance(x, torch.Tensor) else x


def quantize_block(block, calib_data=None, mode="naive", simulate=False):
    """Replace every Dense descendant of `block` with its int8 twin, in
    place, calibrating static activation scales on `calib_data` batches
    when given: forward pre-hooks on the Dense layers record each input's
    range while the block's own forward runs each batch (a batch is one
    input or a tuple of inputs; numpy arrays are moved to the block's
    device). `simulate=True` swaps in dequantize-then-float twins.
    Returns the block."""
    collector = CalibrationCollector(mode)
    if calib_data is not None:
        handles = []
        for _, _, child, path in _walk(block):
            if isinstance(child, _nn.Dense):
                handles.append(child.register_forward_pre_hook(
                    lambda blk, args, path=path: collector.collect(
                        path, args[0])))
        device = next(block.parameters()).device
        try:
            with torch.no_grad():
                for batch in calib_data:
                    batch = batch if isinstance(batch, (list, tuple)) \
                        else (batch,)
                    block(*[_on_device(b, device) for b in batch])
        finally:
            for h in handles:
                h.remove()
    _swap_quantizable(block, collector, mode, simulate=simulate)
    return block


def _swap_quantizable(block, collector, mode, prefix="", simulate=False):
    for name, child in list(block.named_children()):
        if isinstance(child, _nn.Dense):
            setattr(block, name, QuantizedDense(
                child, act_scale=collector.scale(f"{prefix}{name}"),
                mode=mode, simulate=simulate))
        else:
            _swap_quantizable(child, collector, mode, f"{prefix}{name}.",
                              simulate=simulate)
