"""DeepAR probabilistic forecasting (counterpart of
`mxnet_tpu/models/deepar.py`; reference: GluonTS DeepAREstimator, an
autoregressive LSTM emitting the parameters of a distribution, trained
by negative log-likelihood and forecasting by ancestral sampling).

`DeepAR` has the JAX package's layers and parameter paths
(`lstm.l0_i2h_weight`, ..., `proj.weight`, `proj.bias`), so weights
carry across by name. `forward` runs on tensors; `loss` and
`sample_paths` take NDArrays (or tensors) and give NDArrays (tensors),
as the JAX package's do, so `loss` works inside `autograd.record()`
with `.backward()` on what it returns. Sampling draws from the device
stream of `mxnet_tpu_torch.random`.

`device=None` builds the model on the card (raising when there is
none); `device="cpu"` builds it on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import context
from .. import random as _random
from ..gluon import HybridBlock, nn, rnn
from ..ndarray.ndarray import NDArray, _unwrap
from ..ops.nn_ops import softrelu

__all__ = ["GaussianOutput", "NegativeBinomialOutput", "DeepAR",
           "crps_eval"]


class GaussianOutput:
    """Distribution head: raw (..., 2) -> (mu, sigma)."""

    args_dim = 2

    @staticmethod
    def params(raw):
        return raw[..., 0], softrelu(raw[..., 1]) + 1e-6

    @staticmethod
    def nll(raw, target):
        mu, sigma = GaussianOutput.params(raw)
        t = target.float()
        return 0.5 * math.log(2 * math.pi) + torch.log(sigma) + \
            0.5 * torch.square((t - mu) / sigma)

    @staticmethod
    def sample(raw, generator):
        mu, sigma = GaussianOutput.params(raw)
        return mu + sigma * torch.randn(mu.shape, generator=generator,
                                        device=mu.device, dtype=mu.dtype)


class NegativeBinomialOutput:
    """Distribution head: raw (..., 2) -> (mu, alpha), both softplus."""

    args_dim = 2

    @staticmethod
    def params(raw):
        return softrelu(raw[..., 0]) + 1e-6, softrelu(raw[..., 1]) + 1e-6

    @staticmethod
    def nll(raw, target):
        mu, alpha = NegativeBinomialOutput.params(raw)
        t = target.float()
        r = 1.0 / alpha
        p = mu / (mu + r)
        return -(torch.lgamma(t + r) - torch.lgamma(r) - torch.lgamma(t + 1)
                 + r * torch.log(1 - p) + t * torch.log(p))

    @staticmethod
    def sample(raw, generator):
        """Gamma(r) · mu · alpha, then Poisson of that rate (float32
        counts)."""
        mu, alpha = NegativeBinomialOutput.params(raw)
        rate = torch._standard_gamma(1.0 / alpha, generator=generator) \
            * mu * alpha
        return torch.poisson(rate, generator=generator)


def _lagged_input(target, features=None):
    """(B, T) targets -> (B, T-1, 2) LSTM input: the lagged target and
    the feature column (zeros without `features`)."""
    x = target[:, :-1, None].float()
    extra = features[:, :-1].float() if features is not None \
        else torch.zeros_like(x)
    return torch.cat([x, extra], -1)


class DeepAR(HybridBlock):
    """An LSTM over the context window conditioning a distribution head;
    trained by NLL on known targets, forecasting by ancestral sampling.
    The defaults are GluonTS DeepAREstimator's (40 cells, 2 layers,
    dropout 0.1)."""

    def __init__(self, num_cells=40, num_layers=2, context_length=24,
                 prediction_length=12, distr=GaussianOutput, num_features=1,
                 dropout=0.1, device=None):
        super().__init__()
        self.context_length = context_length
        self.prediction_length = prediction_length
        self.distr = distr
        with context.resolve(device):
            self.lstm = rnn.LSTM(num_cells, num_layers=num_layers,
                                 layout="NTC", dropout=dropout,
                                 input_size=num_features + 1)
            self.proj = nn.Dense(distr.args_dim, in_units=num_cells,
                                 flatten=False)

    def forward(self, past_target, features=None):
        """Teacher-forced: past_target (B, T) -> raw distribution
        parameters (B, T-1, args_dim), raw[:, k] predicting target[k+1]
        from target[<=k]."""
        return self.proj(self.lstm(_lagged_input(past_target, features)))

    def loss(self, past_target, features=None):
        """The mean NLL of target[1:] under the teacher-forced forward."""
        boundary = isinstance(past_target, NDArray)
        t, f = _unwrap(past_target), _unwrap(features)
        nll = self.distr.nll(self(t, f), t[:, 1:]).mean()
        return NDArray(nll) if boundary else nll

    def sample_paths(self, context, num_samples=100, features=None):
        """Ancestral sampling: (num_samples, B, prediction_length).

        The samples fold into the batch: one LSTM pass over the tiled
        context, then each forecast step advances the carried state by
        one step. The first step conditions on the LSTM's output after
        the FULL context (`forward` drops the last input, so its last
        row predicts the last observed point, not the first forecast)."""
        if features is not None:
            raise NotImplementedError(
                "sample_paths with covariate features: forecasting would "
                "need future feature values threaded per sampled step; "
                "train/forecast feature-free or extend sample_paths")
        boundary = isinstance(context, NDArray)
        ctx = _unwrap(context).float()
        B = ctx.shape[0]
        S = num_samples
        gen = _random.generator(ctx.device)
        with torch.no_grad():
            x = ctx.repeat(S, 1)[:, :, None]                 # (S*B, T0, 1)
            out, states = self.lstm(torch.cat([x, torch.zeros_like(x)], -1),
                                    [torch.zeros(info["shape"],
                                                 device=ctx.device)
                                     for info in self.lstm.state_info(S * B)])
            raw_next = self.proj(out[:, -1])
            vals = []
            for _ in range(self.prediction_length):
                val = self.distr.sample(raw_next, gen)        # (S*B,)
                vals.append(val)
                xt = val[:, None, None].float()
                out, states = self.lstm(
                    torch.cat([xt, torch.zeros_like(xt)], -1), states)
                raw_next = self.proj(out[:, -1])
            paths = torch.stack(vals, -1).reshape(S, B,
                                                  self.prediction_length)
        return NDArray(paths) if boundary else paths


def crps_eval(samples, target):
    """Sample-based CRPS (GluonTS quality metric), numpy."""
    s = np.asarray(samples)  # (S, B, T)
    t = np.asarray(target)   # (B, T)
    term1 = np.mean(np.abs(s - t[None]), axis=0)
    term2 = 0.5 * np.mean(
        np.abs(s[:, None] - s[None, :]), axis=(0, 1))
    return float(np.mean(term1 - term2))
