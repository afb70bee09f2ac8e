"""CRNN sequence recognition (counterpart of `mxnet_tpu/models/crnn.py`):
conv features -> BiLSTM -> CTC, the classic OCR stack (reference: the
upstream `example/ctc/` family, lstm_ocr.py over warp-ctc, and the CRNN
architecture it popularised).

`CRNN` has the JAX package's layers and parameter paths (`conv.0.weight`,
`lstm.l0_i2h_weight`, `lstm.r0_...`, `head.weight`), so weights carry
across by name; it trains through `parallel.ShardedTrainer` with a loss
over `nd.ctc_loss`, as `examples/ocr/train_crnn.py` does.
`ctc_greedy_decode` and `make_glyph_batch` are numpy, copied from the
JAX package.

`device=None` builds the model on the card (raising when there is
none); `device="cpu"` builds it on the CPU.
"""
from __future__ import annotations

import numpy as np

from .. import context
from ..gluon import HybridBlock, nn, rnn

__all__ = ["CRNN", "ctc_greedy_decode", "make_glyph_batch"]


class CRNN(HybridBlock):
    """(N, 1, H, W) image -> (T=W/2, N, num_classes) CTC logits.

    num_classes INCLUDES the blank at index 0 (blank_label='first');
    real glyph classes are 1..num_classes-1.
    """

    def __init__(self, num_classes, img_height=8, channels=(16, 32),
                 hidden=64, device=None):
        super().__init__()
        self.num_classes = num_classes
        with context.resolve(device):
            self.conv = nn.HybridSequential()
            for i, c in enumerate(channels):
                self.conv.add(nn.Conv2D(c, kernel_size=3, padding=1,
                                        in_channels=1 if i == 0
                                        else channels[i - 1]))
                self.conv.add(nn.Activation("relu"))
                # halve H each stage; halve W only in the LAST stage so
                # the sequence keeps >= one frame per glyph column
                self.conv.add(nn.MaxPool2D(pool_size=2, strides=(2, 2)
                                           if i == len(channels) - 1
                                           else (2, 1)))
            feat_h = img_height // (2 ** len(channels))
            self.lstm = rnn.LSTM(hidden, num_layers=1, bidirectional=True,
                                 input_size=channels[-1] * feat_h)
            self.head = nn.Dense(num_classes, flatten=False,
                                 in_units=2 * hidden)

    def forward(self, x):
        f = self.conv(x)                       # (N, C, H', T)
        N, C, H, T = f.shape
        f = f.reshape(N, C * H, T).permute(2, 0, 1)   # (T, N, C*H')
        return self.head(self.lstm(f))         # (T, N, num_classes)


def ctc_greedy_decode(logits, blank=0):
    """(T, N, C) logits -> list of N label lists: argmax path, collapse
    repeats, drop blanks (reference: the decode loop in
    example/ctc/lstm_ocr.py)."""
    path = np.asarray(logits).argmax(-1)       # (T, N)
    out = []
    for n in range(path.shape[1]):
        seq, prev = [], blank
        for t in path[:, n]:
            if t != prev and t != blank:
                seq.append(int(t))
            prev = t
        out.append(seq)
    return out


def make_glyph_batch(batch, num_glyphs=5, min_len=2, max_len=4,
                     img_height=8, glyph_w=6, noise=0.15, seed=0):
    """Synthetic rendered-string task with a knowable optimum: each glyph
    class g (1..num_glyphs) renders as a deterministic img_height x
    glyph_w binary pattern (seeded); a string of glyphs is drawn at
    random horizontal offsets with pixel noise. 100% sequence accuracy is
    attainable, so a falsifiable gate can sit on top (the
    SyntheticGratings pattern).

    Returns dict(image (N,1,H,W) f32, label (N,max_len) int32 0-padded,
    label_len (N,) int32)."""
    rs = np.random.RandomState(seed)
    glyphs = (np.random.RandomState(1234)
              .rand(num_glyphs + 1, img_height, glyph_w) > 0.5)
    W = max_len * (glyph_w + 2) + 4
    imgs = np.zeros((batch, 1, img_height, W), np.float32)
    labels = np.zeros((batch, max_len), np.int32)
    lens = rs.randint(min_len, max_len + 1, batch).astype(np.int32)
    for n in range(batch):
        x = rs.randint(0, 3)
        for i in range(lens[n]):
            g = rs.randint(1, num_glyphs + 1)
            labels[n, i] = g
            imgs[n, 0, :, x:x + glyph_w] = glyphs[g]
            x += glyph_w + rs.randint(1, 3)
    imgs += noise * rs.randn(*imgs.shape).astype(np.float32)
    return {"image": imgs, "label": labels, "label_len": lens}
