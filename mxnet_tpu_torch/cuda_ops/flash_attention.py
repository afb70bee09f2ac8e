"""Flash attention forward and backward (counterpart of
`mxnet_tpu/pallas_ops/flash_attention.py`).

Layout (batch, heads, seq, head_dim). For CUDA tensors `flash_fwd`
launches the hand-written kernel in `csrc/flash_fwd.cu`, which emits O
and the row log-sum-exp without materialising the L x L scores, and
`flash_bwd` launches the dq and dkv kernels of `csrc/flash_bwd.cu`
(`flash_bwd_dq`, `flash_bwd_dkv`). For CPU tensors each runs its plain
version (`flash_fwd_reference`; `flash_dq_reference`,
`flash_dkv_reference`, `flash_bwd_reference`: the JAX package's
`mha_reference` expression and the same backward formulas). Any other
device raises.

Attention dropout keeps score (bh, row, col) where the Philox bits of its
coordinates clear the threshold (`csrc/dropout.cuh`), so the forward and
both backward kernels regenerate one mask from a 64-bit seed whatever
their tiling, and `dropout_keep_mask` reproduces it bit for bit in plain
torch. `flash_attention` is differentiable: its autograd Function saves
(q, k, v, bias, seed, O, LSE) and its backward is the two kernels, with
delta = rowsum(dO * O) in plain torch as the JAX package computes it.

`launches` counts flash-forward kernel launches, `launches_dq` and
`launches_dkv` the backward kernels' (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_reference",
           "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_reference",
           "flash_dq_reference", "flash_dkv_reference", "dropout_keep_mask",
           "dropout_threshold", "dropout_mask"]

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF

launches = 0
launches_dq = 0
launches_dkv = 0


# -- the dropout keep mask -----------------------------------------------------

def dropout_threshold(p):
    """The keep rule's cutoff: drop where bits < round(p * 2^32) (the TPU
    kernel's rule, `_keep_tile`)."""
    return min(int(round(p * 2.0 ** 32)), _U32)


def _mulhilo(a, m):
    """(hi, lo) 32-bit halves of a * m for int64 tensors a < 2^32 and the
    constant m < 2^32, without overflowing int64: a is split into 16-bit
    halves."""
    ah, al = a >> 16, a & 0xFFFF
    x, y = ah * m, al * m                          # each < 2^48
    lo = (((x & 0xFFFF) << 16) + y) & _U32
    hi = (x + (y >> 16)) >> 16
    return hi, lo


def _philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on int64 tensors holding uint32 values; the key is
    two Python ints. The mirror of `philox4x32_10` in csrc/dropout.cuh."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _U32
        k1 = (k1 + 0xBB67AE85) & _U32
    return c0, c1, c2, c3


def dropout_keep_mask(seed, BH, Lq, Lk, p, device=None):
    """(BH, Lq, Lk) bool keep mask of attention dropout at rate p: element
    (bh, row, col) is kept where word col & 3 of Philox-4x32-10 at counter
    (col >> 2, row, bh, 0) and key (seed low, seed high 32 bits) is at
    least `dropout_threshold(p)`. Bit for bit the kernels' mask."""
    seed = int(seed)
    ng = (Lk + 3) // 4
    shape = (BH, Lq, ng)
    kw = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(ng, **kw).expand(shape)
    c1 = torch.arange(Lq, **kw)[:, None].expand(shape)
    c2 = torch.arange(BH, **kw)[:, None, None].expand(shape)
    c3 = torch.zeros(shape, **kw)
    words = _philox4x32_10(c0, c1, c2, c3, seed & _U32, (seed >> 32) & _U32)
    bits = torch.stack(words, dim=-1).reshape(BH, Lq, 4 * ng)[..., :Lk]
    return bits >= dropout_threshold(p)


def _drop_args(dropout, seed):
    """(seed_lo, seed_hi, threshold, inv_keep, on) for a C entry."""
    if dropout <= 0.0:
        return 0, 0, 0, 1.0, 0
    seed = int(seed)
    return (seed & _U32, (seed >> 32) & _U32, dropout_threshold(dropout),
            1.0 / (1.0 - dropout), 1)


# -- plain versions ------------------------------------------------------------

def _scores(q, k, bias, causal, sm_scale):
    """float32 scores plus the (B, Lk) additive bias row, causal-masked
    entries REPLACED by -1e30 (last query aligned with the last key)."""
    Lq, Lk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    s = s + bias[:, None, None, :]
    if causal:
        row = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        col = torch.arange(Lk, device=q.device)[None, :]
        s = torch.where(col <= row, s, _NEG)
    return s


def _keep(q, k, dropout, seed):
    B, H, Lq, _ = q.shape
    return dropout_keep_mask(seed, B * H, Lq, k.shape[2], dropout,
                             q.device).reshape(B, H, Lq, k.shape[2])


def flash_fwd_reference(q, k, v, bias, causal=False, sm_scale=None,
                        dropout=0.0, seed=0):
    """Plain PyTorch forward: softmax of `_scores` in float32; with
    dropout the kept p is scaled by 1/(1-p) in float32 and the dropped p
    is 0, then p rounds to q.dtype before P.V. The LSE is of the
    undropped scores. Returns (O in q.dtype, LSE (B*H, Lq) float32)."""
    B, H, Lq, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    s = _scores(q, k, bias, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, Lq)
    p = torch.softmax(s, dim=-1)
    if dropout > 0.0:
        p = torch.where(_keep(q, k, dropout, seed), p * (1.0 / (1.0 - dropout)),
                        0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v), lse


def _bwd_terms(q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout,
               seed):
    """(p~ rounded, ds rounded) of the backward, as float32 (B,H,Lq,Lk):
    p = exp(scores - lse), dp = dO.v^T dropped and scaled, ds = p (dp -
    delta) sm_scale rounded to the input dtype, p~ = p dropped, scaled and
    rounded."""
    B, H, Lq, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    dt = q.dtype
    s = _scores(q, k, bias, causal, sm_scale)
    p = torch.exp(s - lse.reshape(B, H, Lq, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    pv = p
    if dropout > 0.0:
        keep = _keep(q, k, dropout, seed)
        inv = 1.0 / (1.0 - dropout)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = (p * (dp - delta.reshape(B, H, Lq, 1)) * sm_scale).to(dt).float()
    return pv.to(dt).float(), ds


def flash_dq_reference(q, k, v, bias, dout, lse, delta, causal=False,
                       sm_scale=None, dropout=0.0, seed=0):
    """Plain dq = ds.k (see `_bwd_terms`), in the input dtype."""
    _, ds = _bwd_terms(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                       dropout, seed)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, bias, dout, lse, delta, causal=False,
                        sm_scale=None, dropout=0.0, seed=0):
    """Plain (dk, dv) = (ds^T.q, p~^T.dO), in the input dtype."""
    pv, ds = _bwd_terms(q, k, v, bias, dout, lse, delta, causal, sm_scale,
                        dropout, seed)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dout.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_reference(q, k, v, bias, dout, lse, delta, causal=False,
                        sm_scale=None, dropout=0.0, seed=0):
    """Plain PyTorch backward, the kernels' formulas on whole matrices
    (`_bwd_terms`). lse and delta are (B*H, Lq) float32. Returns (dq, dk,
    dv) in the input dtype."""
    args = (q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout, seed)
    pv, ds = _bwd_terms(*args)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dout.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# -- kernel wrappers -----------------------------------------------------------

_fns = {}
_DROP_ARGTYPES = [ctypes.c_uint32] * 3 + [ctypes.c_float, ctypes.c_int]


def _entry(name):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    fn = getattr(_build.library(), name)
    fn.restype = ctypes.c_int
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] \
        + _DROP_ARGTYPES + [ctypes.c_void_p]
    fn.argtypes = {
        "mx_flash_fwd": [ctypes.c_void_p] * 6 + tail,
        "mx_flash_bwd_dq": [ctypes.c_void_p] * 8 + tail,
        "mx_flash_bwd_dkv": [ctypes.c_void_p] * 9 + tail,
        "mx_dropout_mask": [ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_uint32] * 3 + [ctypes.c_void_p],
    }[name]
    _fns[name] = fn
    return fn


def _check_inputs(what, q, k, v, bias, extra=()):
    """Device, shape, dtype and contiguity checks shared by the wrappers;
    `extra` holds (name, tensor, shape, dtype) of further operands."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape \
            or bias.shape != (B, Lk):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, bias {tuple(bias.shape)} disagree")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share one dtype, float32 "
                         "or bfloat16")
    if bias.dtype != torch.float32:
        raise ValueError(f"{what}: bias must be float32")
    for name, x, shape, dtype in extra:
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{what}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
    for name, x in [("q", q), ("k", k), ("v", v), ("bias", bias)] \
            + [(e[0], e[1]) for e in extra]:
        if x.device != q.device:
            raise ValueError(f"{what}: {name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        # TMA (bf16) and float4 loads (float32) need 16-byte-aligned bases
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte "
                             "boundary (a fresh allocation does)")
    if D % 8 or D > 128:
        raise ValueError(f"{what}: head dim {D} must be a multiple of 8 "
                         "and <= 128")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_card(q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return True


def flash_fwd(q, k, v, bias, causal=False, sm_scale=None, dropout=0.0,
              seed=0):
    """The forward kernel's wrapper: q (B,H,Lq,D), k/v (B,H,Lk,D) float32
    or bfloat16, bias (B, Lk) float32 additive; attention dropout at rate
    `dropout` keyed by the 64-bit `seed`. Returns (O, LSE)."""
    if not _on_card(q):
        return flash_fwd_reference(q, k, v, bias, causal, sm_scale, dropout,
                                   seed)
    _check_inputs("flash_attention", q, k, v, bias)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    err = _entry("mx_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D, float(sm_scale),
        int(bool(causal)), _DTYPE_CODE[q.dtype], *_drop_args(dropout, seed),
        _stream(q))
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out, lse


def _bwd_prep(what, q, k, v, bias, dout, lse, delta, causal, sm_scale,
              dropout, seed):
    """Checks plus (input pointers, trailing C arguments) of a backward
    entry."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    _check_inputs(what, q, k, v, bias, (
        ("dout", dout, q.shape, q.dtype),
        ("lse", lse, (B * H, Lq), torch.float32),
        ("delta", delta, (B * H, Lq), torch.float32)))
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    return ins, (B, H, Lq, Lk, D, float(sm_scale), int(bool(causal)),
                 _DTYPE_CODE[q.dtype], *_drop_args(dropout, seed), _stream(q))


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, causal=False,
                 sm_scale=None, dropout=0.0, seed=0):
    """The dq kernel's wrapper (arguments as `flash_bwd`). Returns dq."""
    if not _on_card(q):
        return flash_dq_reference(q, k, v, bias, dout, lse, delta, causal,
                                  sm_scale, dropout, seed)
    ins, tail = _bwd_prep("flash_attention dq", q, k, v, bias, dout, lse,
                          delta, causal, sm_scale, dropout, seed)
    dq = torch.empty_like(q)
    _build.check(_entry("mx_flash_bwd_dq")(*ins, dq.data_ptr(), *tail),
                 "flash_attention dq")
    global launches_dq
    launches_dq += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, dout, lse, delta, causal=False,
                  sm_scale=None, dropout=0.0, seed=0):
    """The dkv kernel's wrapper (arguments as `flash_bwd`). Returns
    (dk, dv)."""
    if not _on_card(q):
        return flash_dkv_reference(q, k, v, bias, dout, lse, delta, causal,
                                   sm_scale, dropout, seed)
    ins, tail = _bwd_prep("flash_attention dkv", q, k, v, bias, dout, lse,
                          delta, causal, sm_scale, dropout, seed)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _build.check(_entry("mx_flash_bwd_dkv")(*ins, dk.data_ptr(), dv.data_ptr(),
                                            *tail),
                 "flash_attention dkv")
    global launches_dkv
    launches_dkv += 1
    return dk, dv


def flash_bwd(q, k, v, bias, dout, lse, delta, causal=False, sm_scale=None,
              dropout=0.0, seed=0):
    """The backward: q, dout (B,H,Lq,D), k/v (B,H,Lk,D), bias (B,Lk)
    float32, lse and delta (B*H, Lq) float32 (the forward's LSE and
    rowsum(dO * O)). On the card, the dq kernel, then the dkv kernel; on
    the CPU, `flash_bwd_reference`. Returns (dq, dk, dv) in the input
    dtype."""
    args = (q, k, v, bias, dout, lse, delta, causal, sm_scale, dropout, seed)
    if not _on_card(q):
        return flash_bwd_reference(*args)
    return (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)


def dropout_mask(seed, BH, Lq, Lk, p, device):
    """The kernels' keep mask, (BH, Lq, Lk) bool, computed on the card by
    the device function the attention kernels call (for holding it
    against `dropout_keep_mask`; no model path calls this)."""
    out = torch.empty((BH, Lq, Lk), dtype=torch.uint8, device=device)
    lo, hi, thr, _, _ = _drop_args(p, seed)
    _build.check(_entry("mx_dropout_mask")(
        out.data_ptr(), BH, Lq, Lk, lo, hi, thr, _stream(out)),
        "dropout_mask")
    return out.bool()


# -- the differentiable op -----------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, dropout, seed):
        out, lse = flash_fwd(q, k, v, bias, causal, sm_scale, dropout, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, sm_scale, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, sm_scale, dropout, seed = ctx.args
        B, H, Lq, _ = q.shape
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).reshape(B * H, Lq)
        dq, dk, dv = flash_bwd(q, k, v, bias, dout, lse, delta, causal,
                               sm_scale, dropout, seed)
        # no gradient for the bias (a padding mask) or the seed
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    dropout=0.0, seed=None):
    """Multi-head attention, flash-style (the JAX signature, with an int
    `seed` in place of the JAX dropout key).

    q, k, v: (batch, heads, seq, head_dim), float32 or bfloat16.
    mask: optional (batch, kv_seq), True/1 where attendable.
    dropout: attention-probability dropout rate in [0, 1), applied when a
    64-bit `seed` is given (like the JAX package, no seed means no
    dropout, so inference code never draws one).
    Returns (batch, heads, q_seq, head_dim) in q.dtype; differentiable
    in q, k and v."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"flash_attention: dropout {dropout} is not in "
                         "[0, 1)")
    if seed is None:
        dropout = 0.0
    B, Lk = q.shape[0], k.shape[2]
    if mask is not None:
        bias = torch.where(mask.to(torch.bool), 0.0, _NEG) \
            .to(device=q.device, dtype=torch.float32).contiguous()
    else:
        bias = torch.zeros((B, Lk), dtype=torch.float32, device=q.device)
    return _FlashAttention.apply(q, k, v, bias, bool(causal), sm_scale,
                                 float(dropout), int(seed or 0))
