"""The fused RNN op (counterpart of `mxnet_tpu/ops/rnn_ops.py`).

The JAX op is a `lax.scan` over time, not a Pallas kernel, so here it is
ATen's fused RNN (`torch.lstm`, `torch.gru`, `torch.rnn_tanh`,
`torch.rnn_relu`; cuDNN on the card), one layer a call with both
directions in it. The layers are run one at a time so that inter-layer
dropout draws from the port's own device stream (`nn_ops.dropout`:
x / keep where kept, as the JAX op does): cuDNN's built-in RNN dropout
draws from a state the port does not own. ATen's gate orders are the
JAX op's (LSTM i, f, g, o; GRU r, u, n with the reset gate applied after
the recurrent product). GRU with `linear_before_reset=False` (reset
applied to the state before the recurrent product, ONNX's default) has
no ATen counterpart and runs as a loop over time.

The parameters are one flat vector in cuDNN order (`unpack_rnn_params`);
the gluon layers pass their per-layer Parameters as they are
(`rnn_layers`), and ATen copies them into its own flat buffer on every
call on the card.

Variable lengths (`use_sequence_length`): the state freezes at each
sequence's end, outputs past the end are 0, and the reverse direction
starts at each sequence's own end, as in the JAX op. ATen takes them as
a packed sequence, whose lengths are read on the host (one copy of the
(N,) lengths a call) and must be at least 1; a sequence of length 0
gives zero outputs and its initial state, as in the JAX op.
"""
from __future__ import annotations

import torch
from torch.nn.utils import rnn as _packing

from .. import autograd as _autograd
from . import nn_ops

__all__ = ["rnn", "rnn_layers", "unpack_rnn_params", "rnn_param_size"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_ATEN = {"lstm": torch.lstm, "gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
         "rnn_relu": torch.rnn_relu}


def unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                      bidirectional=False):
    """Split the flat cuDNN-ordered parameter vector into per-layer
    weights, views of `params` ({"wi", "wh", "bi", "bh"} for each layer
    and direction, layer-major). cuDNN order: for each layer and
    direction the input weights, then the recurrent weights; all biases
    follow all weights in the same order (b_i, then b_h)."""
    ngates = GATES[mode]
    dirs = 2 if bidirectional else 1
    layers = []
    off = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            ent = {}
            for key, cols in (("wi", isz), ("wh", state_size)):
                n = ngates * state_size * cols
                ent[key] = params[off:off + n].view(ngates * state_size, cols)
                off += n
            layers.append(ent)
    for ent in layers:
        for key in ("bi", "bh"):
            ent[key] = params[off:off + ngates * state_size]
            off += ngates * state_size
    return layers


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    ngates = GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        size += dirs * ngates * state_size * (isz + state_size + 2)
    return size


def _reverse_padded(x, lengths):
    """Per-sequence time reversal of a padded (T, N, C) batch: row t of
    sequence n becomes row lengths[n]-1-t; rows at or after lengths[n]
    are 0. Self-inverse on the valid rows."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)[:, None]
    idx = (lengths[None, :] - 1 - t).clamp(0, T - 1)
    rev = torch.gather(x, 0, idx[..., None].expand(x.shape))
    return torch.where((t < lengths[None, :])[..., None], rev, 0.0)


def _gru_reset_first(x, ent, h0, lengths, reverse):
    """One direction of a GRU layer with linear_before_reset=False:
    n = tanh(W_n x + b_Wn + (r * h) R_n^T + b_Rn), over time in a loop.
    x (T, N, I), h0 (N, H) -> (ys (T, N, H), h_T)."""
    wi, wh, bi, bh = ent["wi"], ent["wh"], ent["bi"], ent["bh"]
    H = h0.shape[-1]
    if reverse:
        x = x.flip(0) if lengths is None else _reverse_padded(x, lengths)
    zi = x @ wi.T + bi
    h, ys = h0, []
    for t in range(x.shape[0]):
        ri, ui, ni = zi[t].chunk(3, -1)
        rh, uh = (h @ wh[:2 * H].T + bh[:2 * H]).chunk(2, -1)
        r, u = torch.sigmoid(ri + rh), torch.sigmoid(ui + uh)
        n = torch.tanh(ni + (r * h) @ wh[2 * H:].T + bh[2 * H:])
        h_new = (1 - u) * n + u * h
        if lengths is None:
            h = h_new
            ys.append(h)
        else:
            valid = (t < lengths)[:, None]
            h = torch.where(valid, h_new, h)
            ys.append(torch.where(valid, h_new, 0.0))
    ys = torch.stack(ys)
    if reverse:
        ys = ys.flip(0) if lengths is None else _reverse_padded(ys, lengths)
    return ys, h


def _aten_layer(x, ents, h0, c0, mode, packing):
    """One layer, every direction in one ATen call. x (T, N, I), h0/c0
    (dirs, N, H); `packing` None or (host lengths >= 1, lengths == 0 on
    the device). Returns (ys (T, N, dirs*H), h_T, c_T or None)."""
    weights = [w for e in ents for w in (e["wi"], e["wh"], e["bi"], e["bh"])]
    bidirectional = len(ents) == 2
    lstm = mode == "lstm"
    # cuDNN keeps what its backward needs only in training mode
    train = torch.is_grad_enabled()
    if packing is None:
        out = _ATEN[mode](x, [h0, c0] if lstm else h0, weights, True, 1,
                          0.0, train, bidirectional, False)
        return out[0], out[1], out[2] if lstm else None
    host_lengths, empty = packing
    seq = _packing.pack_padded_sequence(x, host_lengths,
                                        enforce_sorted=False)
    order, back = seq.sorted_indices, seq.unsorted_indices
    hx = h0.index_select(1, order)
    if lstm:
        hx = [hx, c0.index_select(1, order)]
    out = _ATEN[mode](seq.data, seq.batch_sizes, hx, weights, True, 1, 0.0,
                      train, bidirectional)
    ys = _packing.pad_packed_sequence(
        _packing.PackedSequence(out[0], seq.batch_sizes, order, back),
        total_length=x.shape[0])[0]
    mask = empty[None, :, None]
    ys = torch.where(mask, 0.0, ys)
    hT = torch.where(mask, h0, out[1].index_select(1, back))
    cT = torch.where(mask, c0, out[2].index_select(1, back)) if lstm \
        else None
    return ys, hT, cT


def rnn_layers(x, layers, state, state_cell=None, mode="lstm",
               bidirectional=False, lengths=None, p=0.0, training=False,
               linear_before_reset=True):
    """The multi-layer (bi)RNN on TNC data x (T, N, I) with `layers` as
    `unpack_rnn_params` gives them; state/state_cell (layers * dirs, N,
    H). Returns (output (T, N, dirs*H), h_n, c_n or None)."""
    dirs = 2 if bidirectional else 1
    num_layers = len(layers) // dirs
    packing = None
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int64)
        packing = (lengths.cpu().clamp(1, x.shape[0]), lengths == 0)
    h_n, c_n = [], []
    for layer in range(num_layers):
        ents = layers[layer * dirs:(layer + 1) * dirs]
        h0 = state[layer * dirs:(layer + 1) * dirs]
        c0 = state_cell[layer * dirs:(layer + 1) * dirs] \
            if mode == "lstm" else None
        if mode == "gru" and not linear_before_reset:
            runs = [_gru_reset_first(x, ent, h0[d], lengths, d == 1)
                    for d, ent in enumerate(ents)]
            x = torch.cat([ys for ys, _ in runs], -1)
            h_n += [h for _, h in runs]
        else:
            x, hT, cT = _aten_layer(x, ents, h0, c0, mode, packing)
            h_n.append(hT)
            if cT is not None:
                c_n.append(cT)
        # inter-layer dropout: between stacked layers, not after the last
        if training and p > 0.0 and layer < num_layers - 1:
            x = nn_ops.dropout(x, p, training=True)
    return (x, torch.cat([h.reshape(-1, *h.shape[-2:]) for h in h_n]),
            torch.cat(c_n) if c_n else None)


def rnn(data, parameters, state, state_cell=None, sequence_length=None,
        state_size=None, num_layers=1, mode="lstm", bidirectional=False,
        p=0.0, state_outputs=False, projection_size=None, layout="TNC",
        use_sequence_length=False, linear_before_reset=True,
        _training=None):
    """Fused multi-layer (bi)RNN, `mx.nd.RNN`. Returns the output, or
    (output, h_n[, c_n]) with `state_outputs`.

    data (T, N, I) for layout 'TNC', (N, T, I) for 'NTC'; parameters flat
    in cuDNN order; `use_sequence_length` with `sequence_length` (N,)
    integer lengths selects the variable-length mode. When mode is not
    'lstm', a lengths tensor given in the `state_cell` slot (as a symbol
    graph binds it positionally) is taken as `sequence_length`.
    `linear_before_reset` (GRU only) False selects ONNX's gate order.
    Inter-layer dropout `p` is active in training (`_training` None: the
    autograd scope's flag, as the JAX op reads it)."""
    if projection_size is not None:
        raise NotImplementedError("RNN: projection_size is not in the port")
    if use_sequence_length and sequence_length is None \
            and mode != "lstm" and state_cell is not None:
        sequence_length, state_cell = state_cell, None
    if layout == "NTC":
        data = data.transpose(0, 1)
    lengths = None
    if use_sequence_length:
        if sequence_length is None:
            raise ValueError("RNN: use_sequence_length without "
                             "sequence_length input")
        lengths = sequence_length
    training = _autograd.is_training() if _training is None else _training
    layers = unpack_rnn_params(parameters, mode, num_layers, data.shape[2],
                               state_size, bidirectional)
    out, h_n, c_n = rnn_layers(data, layers, state, state_cell, mode,
                               bidirectional, lengths, p, training,
                               linear_before_reset)
    if layout == "NTC":
        out = out.transpose(0, 1)
    if not state_outputs:
        return out
    return (out, h_n, c_n) if mode == "lstm" else (out, h_n)
