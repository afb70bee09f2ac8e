#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `mxnet_tpu_torch/csrc`, then:

  1. holds each kernel against its plain PyTorch version on the card at
     the serving shapes, in float32 and bfloat16, and times kernel,
     plain version and the PyTorch library call that computes the same
     function (CUDA events, median of 25 runs, L2 flushed before each);
  2. serves GPT-2 117M (bfloat16, full width, seeded weights) through
     `Server(model, slots=8, pages="on", page_size=16, prefill_chunk=8)`:
     16 requests, prompts of 16-384 tokens, half behind a shared
     128-token prefix, 64 new tokens each, greedy and sampled mixed;
     then a request that fills the 1024-token context beside a peer
     that prefills in the same bucket;
  3. checks, in float32, that pages="on" serves the same greedy tokens
     as pages="off";
  4. runs `GPTForCausalLM.generate` (flash prefill) in bfloat16, and in
     float32 checks its greedy tokens against the pages="off" server's;
  5. times steady decode rounds of the bfloat16 server bare and under
     torch.profiler (device busy time, top kernels);
  6. trains BERT-base (bfloat16, full published widths and depth, seeded
     weights, dropout 0.1) at batch 32 x 512 with 76 masked positions
     through `parallel.ShardedTrainer(model, bert_pretrain_loss, "lamb",
     {"learning_rate": 1e-3, "wd": 0.01})` on a repeated synthetic batch:
     2 warm-up steps, 16 timed steps ended by one host fetch, then one step
     under torch.profiler;
  7. trains a small float32 BERT (dropout 0) 3 LAMB steps on the card and
     the same 3 steps on the CPU (plain versions) from the same weights,
     and holds losses and the final flat master against each other;
  8. pretrains GPT-2 117M (bfloat16, full published widths and depth,
     seeded weights, dropout 0.1, attention dropout 0) at batch 16 x 1024
     through `parallel.ShardedTrainer(model, gpt_lm_loss, "adam",
     {"learning_rate": 1e-3})` on a repeated synthetic batch: 2 warm-up
     steps, 16 timed steps ended by one host fetch, then one step under
     torch.profiler;
  9. trains a small float32 GPT (dropout 0) 3 Adam steps and, from the
     same start, 3 AdamW steps (wd 0.01, clip 1.0) on the card and on the
     CPU, and holds losses and every parameter against each other;
 10. writes phase 8's weights back into its model, quantizes it to int8
     (`contrib.quantization.quantize_block`, calibrated on two training
     batches), serves phase 2's traffic through it and runs `generate`;
     then, on a small float32 GPT, checks that the int8 server's greedy
     tokens equal its `simulate=True` twin's and that a quantized
     forward on the card agrees with the same forward on the CPU;
 11. trains the Switch-FFN mixture-of-experts LM (the JAX package's
     `_dryrun_moe` model: embedding, `h + parallel.moe_apply(h)`, Dense
     head, loss ce + 0.01 aux) at full width, GPT-2's vocabulary of
     50257, d_model 768, d_ff 3072, 8 experts, capacity factor 1.25,
     bfloat16, at batch 16 x 1024 through `parallel.ShardedTrainer(model,
     switch_lm_loss, "adam", {"learning_rate": 1e-3})` on one ep = 1
     mesh: 2 warm-up steps, 16 timed steps ended by one host fetch, then
     one step under torch.profiler; each step launches exactly 2 MoE
     dispatch, 3 MoE combine and 6 Adam kernels;
 12. trains a small float32 Switch LM 3 Adam steps on the card and on
     the CPU from the same weights: equal routing at every step, losses
     and every parameter within TOL_TRAIN.

Phase 1 also holds the training kernels against their plain versions at
the training shapes: the flash forward with dropout 0.1 (its keep mask
bit for bit), the dq and dkv backward kernels over a grid of dtypes,
masks, causality and dropout, the forward, dq and dkv at GPT-2
pretraining's (16,12,1024,64) causal shape, both LAMB passes at
BERT-base's flat master size, the Adam/AdamW update at GPT-2's largest
parameter (the 50257 x 768 token embedding, bfloat16) and at a
768-element float32 LayerNorm vector, bit for bit, and the int8 GEMM at
the four (K, O) shapes of a GPT-2 layer for M = 8 (decode) and M = 1024
(prefill), bit for bit, and the MoE dispatch and combine at the Switch
LM's full width (16,384 tokens, 768 wide, 8 experts of capacity 2,560)
on `moe_route`'s routing with capacity drops, bit for bit, and on random
routing with duplicate slots (dispatch within rtol and atol 1e-6).

Each path runs with the kernels' launch counters set to 0 just before
it and read just after; a kernel of the path that never launched fails
the run. Any failed check raises, and the script exits non-zero. It
needs one CUDA card and the repository around it: without either it
exits with code 2 and prints no result. It imports nothing of JAX.

The last lines of standard output are the card's name and power limit,
one JSON line with the kernels' numbers, and the result line
`{"ok": true, "device": {...}}`.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances: float32 2e-5 (paged) / 1e-4 (flash: tiles sum in another
# order than one softmax); bfloat16 2e-2, as the JAX package's kernel tests
TOL = {"paged": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash": {"float32": 1e-4, "bfloat16": 2e-2}}
# backward kernels: float32 1e-4; bfloat16 2e-2 of the largest |reference|
# (gradients reach |x| >> 1, where one bf16 ulp is more than 2e-2).
# LAMB: rtol 1e-5 (FMA contraction and another order of the 512-lane row
# sums). Card-vs-CPU training (float32, 3 steps): 1e-4 on losses and on
# the flat master (sums run in other orders on the two devices).
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LAMB = 1e-5
TOL_TRAIN = 1e-4
# Adam (w, m and v) and the int8 GEMM: bit for bit (each kernel rounds
# every operation as its plain version does). Card-vs-CPU quantized
# forward: see int8_narrow_phase.
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
F32_FLOPS = 67e12                  # float32 outside the tensor cores
INT8_OPS = 1979e12                 # dense tensor-core int8 peak
TOL_INT8_FWD = 2e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def time_ms(fn, iters=25, warmup=3):
    """Median CUDA-event time of fn() in ms, L2 flushed before each run."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters=20, match=None, attempts=3,
              skip=("fill", "memset")):
    """Device time per call of fn from torch.profiler: the summed device
    time of the kernels it launched (only those whose name contains
    `match` when given), L2 flushed before each call and the flush left
    out (with every kernel whose lower-cased name contains a word of
    `skip`; `FLUSH_ONLY` leaves out the flush alone, so a zero-fill of
    fn's own counts). Unlike time_ms it does not count the caller's host
    time, which exceeds the device time of a small kernel (an int8 GEMM
    at M = 8). The profiler can lose kernel records: a window whose count
    of such kernels is not a whole multiple of `iters` is profiled again,
    and `attempts` windows without a whole one fail the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total, launched, skipped = 0.0, 0, 0
        for name, us, count in kernel_rows(prof):
            low = name.lower()
            if any(word in low for word in skip):
                skipped += count
                continue
            if match is None or match in name:
                total += us
                launched += count
        # the flushes are among the skipped kernels, or they were counted
        if launched and launched % iters == 0 and skipped >= iters:
            return total / 1e3 / iters
    check(False, f"profiler lost kernel records in {attempts} windows "
          f"({launched} kernels for {iters} calls, {skipped} skipped, "
          f"match={match!r})")


# the L2 flush of time_ms and device_ms: a uint8 zero-fill
FLUSH_ONLY = ("fillfunctor<unsigned char>", "memset")


def kernel_rows(prof):
    """(kernel name, device µs, launches) of a torch.profiler window
    (kernel rows only: an op row's self device time repeats its
    kernels')."""
    from torch.autograd import DeviceType
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us > 0:
            yield e.key, us, e.count


def kernel_times(prof):
    """{kernel name: device µs} of a torch.profiler window."""
    out = {}
    for key, us, _ in kernel_rows(prof):
        out[key] = out.get(key, 0.0) + us
    return out


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(dev, dtype, B=8, H=12, D=64, ps=16, n_pg=64, P=520, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, H, 1, D), dtype=dtype, device=dev)
    kp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    vp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    tables = torch.tensor(rng.randint(0, P, (B, n_pg)), dtype=torch.int32,
                          device=dev)
    t = torch.tensor(rng.randint(0, n_pg * ps, (B,)), dtype=torch.int32,
                     device=dev)
    return q, kp, vp, tables, t


def paged_phase(dev, timed=True, **shape):
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    errs = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        case = paged_case(dev, dtype, **shape)
        got = pa.paged_attention(*case)
        ref = pa.paged_attention_reference(*case)
        errs[name] = max_err(got, ref)
        check(errs[name] <= TOL["paged"][name],
              f"paged_attention {name} max_abs_err {errs[name]}")
    q, kp, vp, tables, t = case                       # bfloat16, main path
    B, H, _, D = q.shape
    ps, n_pg = kp.shape[2], tables.shape[1]
    L = n_pg * ps
    es = q.element_size()
    need = int((t.long() + 1).sum())                  # positions <= t[b]
    pages_read = int(torch.clamp(t.long() // ps + 1, max=n_pg).sum())
    nbytes = (2 * B * H * D * es + 2 * need * H * D * es
              + 4 * (pages_read + B))
    flops = 4 * need * H * D
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out = {"name": "paged_attention", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas_ops/paged_attention.py:69",
           "max_abs_err": errs["bfloat16"],
           "max_abs_err_f32": errs["float32"],
           "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
           >= flops / BF16_FLOPS else "operations",
           "shapes": f"q ({B},{H},1,{D}) bf16, pages ({kp.shape[0]},{H},"
                     f"{ps},{D}), tables ({B},{n_pg}), random t "
                     f"(sum t+1 = {need})"}
    if timed:
        mask = torch.arange(L, device=dev)[None, None, None, :] \
            <= t.long()[:, None, None, None]

        def library():
            kc = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, H, L, D)
            vc = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, H, L, D)
            return tF.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)

        lib_err = max_err(library(), pa.paged_attention_reference(*case))
        check(lib_err <= TOL["paged"]["bfloat16"],
              f"paged library yardstick disagrees ({lib_err})")
        k_ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tables, t))
        out.update(ms=k_ms, kernel_ms=k_ms,
                   plain_ms=time_ms(lambda: pa.paged_attention_reference(
                       q, kp, vp, tables, t)),
                   library_ms=time_ms(library))
    return out


def flash_cases(dev, dtype, B=8, H=12, D=64, seed=0):
    """(name, q, k, v, bias, causal) at the serving widths: L=512 causal,
    L=300 with a padding mask, and Lq < Lk causal."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)

    def qkv(Lq, Lk):
        return [torch.tensor(rng.randn(B, H, L_, D), dtype=dtype, device=dev)
                for L_ in (Lq, Lk, Lk)]

    cases = []
    q, k, v = qkv(512, 512)
    cases.append(("causal_512", q, k, v,
                  torch.zeros((B, 512), device=dev), True))
    q, k, v = qkv(300, 300)
    bias = torch.zeros((B, 300), device=dev)
    for b in range(1, B):                             # row b keeps 300-37b
        bias[b, 300 - 37 * b:] = -1e30
    cases.append(("masked_300", q, k, v, bias, False))
    q, k, v = qkv(128, 512)
    cases.append(("causal_128x512", q, k, v,
                  torch.zeros((B, 512), device=dev), True))
    return cases


def flash_phase(dev, timed=True, **shape):
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    errs = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for case, q, k, v, bias, causal in flash_cases(dev, dtype, **shape):
            o, lse = fa.flash_fwd(q, k, v, bias, causal)
            ro, rlse = fa.flash_fwd_reference(q, k, v, bias, causal)
            e = max(max_err(o, ro), max_err(lse, rlse))
            check(e <= TOL["flash"][name],
                  f"flash {case} {name} max_abs_err {e}")
            worst = max(worst, e)
        errs[name] = worst
    _, q, k, v, bias, causal = flash_cases(dev, torch.bfloat16, **shape)[0]
    B, H, L, D = q.shape
    pairs = B * H * L * (L + 1) // 2                  # causal (q, k) pairs
    flops = 4 * pairs * D
    nbytes = 4 * B * H * L * D * q.element_size() + 4 * B * H * L + 4 * B * L
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "mxnet_tpu/pallas_ops/flash_attention.py:148",
           "max_abs_err": errs["bfloat16"],
           "max_abs_err_f32": errs["float32"],
           "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
           >= flops / BF16_FLOPS else "operations",
           "shapes": f"q/k/v ({B},{H},{L},{D}) bf16 causal (errors also "
                     "at L=300 padded and Lq=128 < Lk=512 causal)"}
    if timed:
        lib_err = max_err(
            tF.scaled_dot_product_attention(q, k, v, is_causal=True),
            fa.flash_fwd_reference(q, k, v, bias, True)[0])
        check(lib_err <= TOL["flash"]["bfloat16"],
              f"flash library yardstick disagrees ({lib_err})")
        k_ms = time_ms(lambda: fa.flash_fwd(q, k, v, bias, True))
        out.update(ms=k_ms, kernel_ms=k_ms,
                   plain_ms=time_ms(lambda: fa.flash_fwd_reference(
                       q, k, v, bias, True)),
                   library_ms=time_ms(lambda: tF.scaled_dot_product_attention(
                       q, k, v, is_causal=True)))
    return out


def bound(nbytes, flops, rate=BF16_FLOPS):
    """(bound ms, what binds) of work moving nbytes and doing `flops`
    operations at peak `rate` (bf16 tensor cores by default)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def train_flash_case(dev, dtype, B, causal=False, padded=False, H=12, L=512,
                     D=64, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.tensor(rng.randn(B, H, L, D), dtype=dtype,
                               device=dev) for _ in range(4))
    bias = torch.zeros((B, L), device=dev)
    if padded:
        for b in range(1, B):
            bias[b, L - 37 * b:] = -1e30
    return q, k, v, g, bias


def train_flash_phase(dev, B=32, grid_B=2, p=0.1, seed=0x5EED_1234_ABCD):
    """The flash kernels of the training path against their plain
    versions: the forward with dropout (mask bit for bit, O and LSE), dq
    and dkv over dtype x padding x causal x dropout at (grid_B,12,512,64),
    then the main-path shapes (B,12,512,64) bf16, dropout p, timed."""
    import itertools
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    errs = {"dq": {}, "dkv": {}}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for padded, causal, drop in itertools.product((False, True),
                                                      (False, True),
                                                      (0.0, p)):
            q, k, v, g, bias = train_flash_case(dev, dtype, grid_B, causal,
                                                padded)
            args = (q, k, v, bias)
            ro, lse = fa.flash_fwd_reference(*args, causal, dropout=drop,
                                             seed=seed)
            delta = (g.float() * ro.float()).sum(-1).reshape(lse.shape)
            bw = args + (g, lse, delta, causal, None, drop, seed)
            ref = fa.flash_bwd_reference(*bw)
            scale = max(float(x.float().abs().max()) for x in ref)
            tol = TOL_BWD[name] * (scale if name == "bfloat16" else 1.0)
            dq = fa.flash_bwd_dq(*bw)
            dk, dv = fa.flash_bwd_dkv(*bw)
            case = f"{name} padded={padded} causal={causal} dropout={drop}"
            e_dq = max_err(dq, ref[0])
            e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
            check(e_dq <= tol, f"flash dq {case}: max_abs_err {e_dq} > {tol}")
            check(e_dkv <= tol, f"flash dkv {case}: max_abs_err {e_dkv} > "
                  f"{tol}")
            errs["dq"][name] = max(errs["dq"].get(name, 0.0), e_dq)
            errs["dkv"][name] = max(errs["dkv"].get(name, 0.0), e_dkv)

    q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B)
    BH, L, D = B * 12, q.shape[2], q.shape[3]
    es = q.element_size()
    mask_k = fa.dropout_mask(seed, BH, L, L, p, dev)
    mask_p = fa.dropout_keep_mask(seed, BH, L, L, p, dev)
    check(torch.equal(mask_k, mask_p), "dropout keep mask: kernel and plain "
          f"version differ at {int((mask_k != mask_p).sum())} elements")
    keep = float(mask_k.float().mean())
    del mask_k, mask_p
    o, lse = fa.flash_fwd(q, k, v, bias, False, dropout=p, seed=seed)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                      seed=seed)
    e_fwd = max(max_err(o, ro), max_err(lse, rlse))
    check(e_fwd <= TOL["flash"]["bfloat16"],
          f"flash fwd dropout max_abs_err {e_fwd}")
    delta = (g.float() * ro.float()).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, False, None, p, seed)
    ref = fa.flash_bwd_reference(*bw)
    scale = max(float(x.float().abs().max()) for x in ref)
    tol = TOL_BWD["bfloat16"] * scale
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
    check(e_dq <= tol and e_dkv <= tol,
          f"flash bwd main shapes: dq {e_dq}, dkv {e_dkv} > {tol}")
    del ref, dk, dv

    shapes = f"q/k/v/dO ({B},12,{L},{D}) bf16, no mask, dropout {p}"
    io = BH * L * D * es
    rows = {}
    f_fwd = 4 * BH * L * L * D
    rows["flash_attention_fwd_dropout"] = dict(
        name="flash_attention_fwd_dropout", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_fwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:148",
        max_abs_err=e_fwd, keep_rate=keep, mask_bit_exact=True,
        shapes=shapes)
    rows["flash_attention_fwd_dropout"]["bound_ms"], \
        rows["flash_attention_fwd_dropout"]["bound_by"] = bound(
            4 * io + 4 * BH * L + 4 * B * L, f_fwd)
    rows["flash_attention_dq"] = dict(
        name="flash_attention_dq", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_bwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:245",
        max_abs_err=e_dq, max_abs_err_f32=errs["dq"]["float32"],
        max_abs_err_bf16_grid=errs["dq"]["bfloat16"], shapes=shapes)
    rows["flash_attention_dq"]["bound_ms"], \
        rows["flash_attention_dq"]["bound_by"] = bound(
            5 * io + 8 * BH * L + 4 * B * L, 6 * BH * L * L * D)
    rows["flash_attention_dkv"] = dict(
        name="flash_attention_dkv", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_bwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:287",
        max_abs_err=e_dkv, max_abs_err_f32=errs["dkv"]["float32"],
        max_abs_err_bf16_grid=errs["dkv"]["bfloat16"], shapes=shapes)
    rows["flash_attention_dkv"]["bound_ms"], \
        rows["flash_attention_dkv"]["bound_by"] = bound(
            6 * io + 8 * BH * L + 4 * B * L, 8 * BH * L * L * D)

    # library yardstick: SDPA forward + backward, dropout 0 (rows 2-3
    # together; its dropout draws another mask, so none is compared)
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def library():
        out = tF.scaled_dot_product_attention(ql, kl, vl)
        torch.autograd.grad(out, (ql, kl, vl), g)

    lib_ms = time_ms(library)
    rows["flash_attention_fwd_dropout"].update(
        ms=time_ms(lambda: fa.flash_fwd(q, k, v, bias, False, dropout=p,
                                        seed=seed)),
        plain_ms=time_ms(lambda: fa.flash_fwd_reference(
            q, k, v, bias, False, dropout=p, seed=seed), iters=5),
        library_ms=time_ms(lambda: tF.scaled_dot_product_attention(q, k, v)),
        library="SDPA forward, dropout 0")
    rows["flash_attention_dq"].update(
        ms=time_ms(lambda: fa.flash_bwd_dq(*bw)),
        plain_ms=time_ms(lambda: fa.flash_dq_reference(*bw), iters=5),
        library_ms=lib_ms,
        library="SDPA forward+backward, dropout 0 (rows dq and dkv together)")
    rows["flash_attention_dkv"].update(
        ms=time_ms(lambda: fa.flash_bwd_dkv(*bw)),
        plain_ms=time_ms(lambda: fa.flash_dkv_reference(*bw), iters=5),
        library_ms=lib_ms,
        library="SDPA forward+backward, dropout 0 (rows dq and dkv together)")
    return rows


def gpt_flash_phase(dev, B=16, L=1024, seed=1):
    """The flash kernels at GPT-2 pretraining's shape (phase 8's path):
    (B,12,L,64) bf16, causal, dropout 0, every key valid (16 key tiles and
    the causal tile skip), forward, dq and dkv against their plain
    versions on the same inputs, then timed. Returns {row: extra fields}."""
    import torch
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B, L=L,
                                        seed=seed)
    BH, D, es = B * 12, q.shape[3], q.element_size()
    o, lse = fa.flash_fwd(q, k, v, bias, True)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, True)
    e_o, e_lse = max_err(o, ro), max_err(lse, rlse)
    check(max(e_o, e_lse) <= TOL["flash"]["bfloat16"],
          f"flash fwd GPT-2 shape: O {e_o}, LSE {e_lse}")
    del o, lse
    delta = (g.float() * ro.float()).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, True, None, 0.0, 0)
    ref = fa.flash_bwd_reference(*bw)
    tol = TOL_BWD["bfloat16"] * max(float(x.float().abs().max()) for x in ref)
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dk, e_dv = max_err(dk, ref[1]), max_err(dv, ref[2])
    check(max(e_dq, e_dk, e_dv) <= tol,
          f"flash bwd GPT-2 shape: dq {e_dq}, dk {e_dk}, dv {e_dv} > {tol}")
    del ro, ref, dk, dv
    io = BH * L * D * es
    pairs = BH * L * (L + 1) // 2                     # causal (q, k) pairs
    shape = f"q/k/v/dO ({B},12,{L},{D}) bf16, causal, dropout 0"
    out = {}
    for row, err, nbytes, flops, fn in (
            ("flash_attention_fwd", max(e_o, e_lse),
             4 * io + 4 * BH * L + 4 * B * L, 4 * pairs * D,
             lambda: fa.flash_fwd(q, k, v, bias, True)),
            ("flash_attention_dq", e_dq, 5 * io + 8 * BH * L + 4 * B * L,
             6 * pairs * D, lambda: fa.flash_bwd_dq(*bw)),
            ("flash_attention_dkv", max(e_dk, e_dv),
             6 * io + 8 * BH * L + 4 * B * L, 8 * pairs * D,
             lambda: fa.flash_bwd_dkv(*bw))):
        b_ms, b_by = bound(nbytes, flops)
        out[row] = {"gpt2_train_shape": dict(
            shapes=shape, max_abs_err=err, ms=time_ms(fn), bound_ms=b_ms,
            bound_by=b_by)}
    out["flash_attention_dq"]["gpt2_train_shape"]["tol"] = tol
    out["flash_attention_dkv"]["gpt2_train_shape"]["tol"] = tol
    return out


def bert_base_rows():
    """Rows of BERT-base's flat float32 master (FusedLamb layout), from
    the parameter shapes alone (the model built on the meta device)."""
    from mxnet_tpu_torch.models import bert
    from mxnet_tpu_torch.parallel import FusedLamb
    m = bert.BERTForPretraining(bert.bert_base_config(), device="meta")
    ps = list(m.collect_params().values())
    return FusedLamb([p.shape for p in ps], [p.dtype for p in ps],
                     [0.0] * len(ps), 0.9, 0.999, 1e-6, True, 1.0, -1.0,
                     -1.0, -1.0).n_rows


def lamb_phase(dev, seed=0):
    """Both LAMB passes against their plain versions at BERT-base's flat
    size (R rows of 512 float32), timed on copies so each run sees the
    same state."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    R = bert_base_rows()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rows(scale):
        return torch.randn((R, 512), generator=gen, device=dev) * scale

    W, G, m = rows(0.05), rows(1e-3), rows(1e-4)
    v = rows(1e-4).square()
    wd = torch.tensor(np.where(np.arange(R) % 3, 0.01, 0.0),
                      dtype=torch.float32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    m1, v1, m2, v2 = m.clone(), v.clone(), m.clone(), v.clone()
    rw, ru = fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw)
    rrw, rru = fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)
    e1 = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
             for a, b in ((m1, m2), (v1, v2), (rw, rrw), (ru, rru)))
    check(e1 <= TOL_LAMB, f"lamb_pass1 max relative err {e1}")
    trust = torch.rand(R, generator=gen, device=dev) + 0.5
    W1, W2 = W.clone(), W.clone()
    fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                  bias_correction=True)
    fu.lamb_pass2_reference(W2, m1, v1, wd, trust, c1, c2, 1e-3,
                            epsilon=1e-6, bias_correction=True)
    e2 = max_err(W1, W2) / float(W2.abs().max())
    check(e2 <= TOL_LAMB, f"lamb_pass2 max relative err {e2}")
    n = R * 512 * 4
    shapes = f"W/G/m/v ({R}, 512) float32 ({R * 512} elements)"
    out = {}
    for name, line, err, nbytes, flops, k_fn, p_fn in (
            ("lamb_pass1", 174, e1, 6 * n + 12 * R, 20 * R * 512,
             lambda: fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw),
             lambda: fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)),
            ("lamb_pass2", 205, e2, 4 * n + 8 * R, 10 * R * 512,
             lambda: fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3,
                                   epsilon=1e-6, bias_correction=True),
             lambda: fu.lamb_pass2_reference(W2, m1, v1, wd, trust, c1, c2,
                                             1e-3, epsilon=1e-6,
                                             bias_correction=True))):
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        out[name] = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/fused_update.cu",
            replaces=f"mxnet_tpu/pallas_ops/fused_update.py:{line}",
            max_abs_err=err, error_is="relative to the largest |reference|",
            bound_ms=b_ms, bound_by=b_by, flops_per_call=flops,
            ms=time_ms(k_fn), plain_ms=time_ms(p_fn, iters=5),
            library_ms=None,
            library="none: no single PyTorch call computes a LAMB pass",
            shapes=shapes)
    return out


def adam_case(dev, n, dtype, seed=0):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = (torch.randn(n, generator=gen, device=dev) * 0.05).to(dtype)
    g = (torch.randn(n, generator=gen, device=dev) * 1e-2).to(dtype)
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = (torch.randn(n, generator=gen, device=dev) * 1e-3).square()
    return w, g, m, v


def adam_phase(dev):
    """adam_update against its plain version: Adam and AdamW, clip off
    and on, a bf16 weight of GPT-2's token-embedding size and a float32
    LayerNorm vector; then kernel, plain version and torch's fused Adam
    timed at the large size."""
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    n_big = 50257 * 768
    lr_t = 1e-3 * (1 - 0.999 ** 3) ** 0.5 / (1 - 0.9 ** 3)
    worst = {"w_bf16_ulps": 0.0, "w_f32_rel": 0.0, "moments_rel": 0.0}
    for n, dtype in ((n_big, torch.bfloat16), (768, torch.float32)):
        for decoupled in (False, True):
            for clip in (-1.0, 1e-2):
                kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                          wd=0.01 if decoupled else 0.0, rescale_grad=1.0,
                          clip_gradient=clip, decoupled_wd=decoupled)
                w, g, m, v = adam_case(dev, n, dtype)
                rw, rm, rv = fu.adam_update_reference(w, g, m, v, lr_t, **kw)
                fu.adam_update(w, g, m, v, lr_t, **kw)       # in place
                torch.cuda.synchronize()
                # diagnostics only: the gate is equality
                for a, b in ((m, rm), (v, rv)):
                    e = max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    worst["moments_rel"] = max(worst["moments_rel"], e)
                if dtype == torch.bfloat16:
                    ulp = rw.float().abs().clamp(min=1e-38) * 2.0 ** -7
                    worst["w_bf16_ulps"] = max(worst["w_bf16_ulps"], float(
                        ((w.float() - rw.float()).abs() / ulp).max()))
                else:
                    worst["w_f32_rel"] = max(
                        worst["w_f32_rel"],
                        max_err(w, rw) / float(rw.abs().max()))
                for name, a, b in (("w", w, rw), ("m", m, rm), ("v", v, rv)):
                    check(torch.equal(a, b),
                          f"adam {name} n={n} {kw}: {int((a != b).sum())} "
                          f"elements differ, max_abs_err {max_err(a, b)}")
                del w, g, m, v, rw, rm, rv
    w, g, m, v = adam_case(dev, n_big, torch.bfloat16, seed=1)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
              clip_gradient=-1.0)

    def kernel():
        fu.adam_update(w, g, m, v, lr_t, **kw)

    k_ms = device_ms(kernel)
    ev_ms = time_ms(kernel)
    p_ms = device_ms(lambda: fu.adam_update_reference(w, g, m, v, lr_t,
                                                      **kw), iters=5)
    del w, g, m, v
    # torch's fused Adam keeps its moments in the parameter's dtype, so the
    # yardstick and a second kernel timing run all-float32 at the same n
    w, g, m, v = adam_case(dev, n_big, torch.float32, seed=2)
    k32_ms = device_ms(kernel)
    step = torch.tensor(3.0, device=dev)
    lib_ms = device_ms(lambda: torch._fused_adam_(
        [w], [g], [m], [v], [], [step], lr=1e-3, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False))
    del w, g, m, v
    b_ms, b_by = bound(22 * n_big, 15 * n_big, F32_FLOPS)
    return {"adam_update": dict(
        name="adam_update", route="cuda",
        source="mxnet_tpu_torch/csrc/fused_update.cu",
        replaces="mxnet_tpu/pallas_ops/fused_update.py:86",
        max_abs_err=worst["w_bf16_ulps"],
        bit_exact=True,
        error_is="gate: w, m and v equal the plain version's (torch.equal); "
                 "reported: largest |kernel - plain| of a bf16 weight in "
                 "bf16 ulps of the plain value, float32 weight and moments "
                 "relative to the largest |plain| in max_rel_err_f32_w / "
                 "max_rel_err_moments",
        max_rel_err_f32_w=worst["w_f32_rel"],
        max_rel_err_moments=worst["moments_rel"],
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, kernel_ms_f32_same_n=k32_ms, event_ms=ev_ms,
        times_are="device time per call (torch.profiler, L2 flushed); "
                  "event_ms: CUDA events around the wrapper call",
        library="torch._fused_adam_, all float32 at the same element count "
                "(its moments take the parameter's dtype; its epsilon and "
                "weight decay differ from MXNet's): a time yardstick only",
        shapes=f"w, g ({n_big},) bf16 (GPT-2 word_embed), m, v float32; "
               "errors also at 768 float32")}


GPT2_GEMMS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def int8_case(dev, M, K, O, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x_q = torch.tensor(rng.randint(-127, 128, (M, K)), dtype=torch.int8,
                       device=dev)
    w_q = torch.tensor(rng.randint(-127, 128, (K, O)), dtype=torch.int8,
                       device=dev)
    s_x = torch.tensor(0.017, device=dev)
    w_s = torch.tensor(rng.rand(O) * 1e-2 + 1e-4, dtype=torch.float32,
                       device=dev)
    b = torch.tensor(rng.randn(O), dtype=torch.float32, device=dev)
    return x_q, w_q, s_x, w_s, b


def int8_phase(dev):
    """int8_matmul against its plain version, bit for bit, at GPT-2's four
    layer GEMMs for M = 8 and 1024: with bias, without, with relu, with
    a per-tensor scale; then kernel, plain version and cuBLASLt's int8
    product (torch._int_mm) plus the epilogue in torch timed, bias on."""
    import torch
    from mxnet_tpu_torch.cuda_ops import int8_matmul as im
    by_shape = {}
    for M in (8, 1024):
        for K, O in GPT2_GEMMS:
            x_q, w_q, s_x, w_s, b = int8_case(dev, M, K, O, seed=M + K + O)
            for what, kw in (("bias", dict(bias=b)), ("no bias", {}),
                             ("bias relu", dict(bias=b, relu=True)),
                             ("per-tensor", dict(bias=b))):
                ws = w_s[:1].contiguous() if what == "per-tensor" else w_s
                got = im.int8_matmul(x_q, w_q, s_x, ws, **kw)
                ref = im.int8_matmul_reference(x_q, w_q, s_x, ws, **kw)
                check(torch.equal(got, ref) and not got.isnan().any(),
                      f"int8_matmul ({M},{K},{O}) {what}: max_abs_err "
                      f"{max_err(got, ref)}, not bit for bit")
            Mp = max(24, (M + 7) // 8 * 8)            # what _int_mm takes
            x_pad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
            x_pad[:M] = x_q
            s = s_x * w_s

            def library():
                return torch._int_mm(x_pad, w_q)[:M].float() * s + b

            check(torch.equal(library(), im.int8_matmul_reference(
                x_q, w_q, s_x, w_s, bias=b)), f"_int_mm yardstick ({M},{K},"
                  f"{O}) disagrees")
            b_ms, b_by = bound(M * K + K * O + 8 * O + 4 * M * O,
                               2 * M * K * O, INT8_OPS)
            def kernel():
                return im.int8_matmul(x_q, w_q, s_x, w_s, bias=b)

            by_shape[f"{M}x{K}x{O}"] = dict(
                ms=device_ms(kernel, match="int8_gemm"),
                wrapper_ms=device_ms(kernel), event_ms=time_ms(kernel),
                plain_ms=device_ms(lambda: im.int8_matmul_reference(
                    x_q, w_q, s_x, w_s, bias=b), iters=5),
                library_ms=device_ms(library), bound_ms=b_ms, bound_by=b_by)
    keys = ("ms", "wrapper_ms", "event_ms", "plain_ms", "library_ms",
            "bound_ms")
    layer = {M: {k: sum(v[k] for key, v in by_shape.items()
                        if key.startswith(f"{M}x")) for k in keys}
             for M in (8, 1024)}
    return {"int8_matmul": dict(
        name="int8_matmul", route="cuda",
        source="mxnet_tpu_torch/csrc/int8_matmul.cu",
        replaces="mxnet_tpu/pallas_ops/int8_matmul.py:51",
        max_abs_err=0.0, bit_exact=True,
        ms=layer[8]["ms"], plain_ms=layer[8]["plain_ms"],
        library_ms=layer[8]["library_ms"], bound_ms=layer[8]["bound_ms"],
        bound_by="bytes",
        wrapper_ms=layer[8]["wrapper_ms"], event_ms=layer[8]["event_ms"],
        times_are="sums over one GPT-2 layer's four GEMMs (K,O) = "
                  "(768,2304), (768,768), (768,3072), (3072,768) at M = 8 "
                  "(decode); M = 1024 in layer_m1024, each in by_shape. "
                  "Device time per call (torch.profiler, L2 flushed): ms "
                  "the GEMM kernel alone, wrapper_ms every kernel of the "
                  "wrapper call (with the scale product), plain_ms and "
                  "library_ms every kernel of theirs; event_ms: CUDA "
                  "events around the wrapper call, host time included",
        layer_m1024=layer[1024], by_shape=by_shape,
        library="torch._int_mm (cuBLASLt int8, M padded to 24 at M = 8) "
                "+ the rescale and bias in torch",
        shapes="x_q (M, K) int8, w_q_t (K, O) int8, s, bias (O,) float32")}


MOE_FULL = dict(N=16 * 1024, D=768, E=8)       # phase 11's tokens and widths


def moe_case(dev, N, D, E, C, seed=0):
    """Full-width MoE inputs: tokens with a shared offset and a router that
    leans to expert 0, so `moe_route` overflows its capacity (about a
    tenth of the tokens dropped); plus random routing with duplicate
    slots, invalid experts (-1, E) and positions (-1, >= C)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(N, D).astype(np.float32) + 0.2, device=dev)
    router = rng.randn(D, E).astype(np.float32) * 0.02
    router[:, 0] += 0.004
    dup = (torch.tensor(rng.randint(-1, E + 1, N), dtype=torch.int32,
                        device=dev),
           torch.tensor(rng.randint(-1, C + 2, N), dtype=torch.int32,
                        device=dev),
           torch.tensor(rng.rand(N), dtype=torch.float32, device=dev))
    return x, torch.tensor(router, device=dev), dup


def moe_phase(dev):
    """dispatch_to_experts and combine_from_experts against their plain
    versions (the one-hot einsums, TF32 off) at the Switch LM's full
    width, N = 16,384 tokens of D = 768 over E = 8 experts of capacity
    C = 2,560: on `moe_route`'s routing of a seeded router (capacity
    drops included) bit for bit, and on random routing with duplicates
    and invalid entries (combine bit for bit; dispatch, whose duplicate
    slots sum in another order, within the JAX kernel test's rtol and
    atol of 1e-6).
    Then kernel, plain version and the library call (index_add_ for
    dispatch, index_select and a multiply for combine) timed on the
    moe_route routing, device time, L2 flushed."""
    import torch
    from mxnet_tpu_torch.cuda_ops import moe_kernels as mk
    from mxnet_tpu_torch.parallel import moe
    N, D, E = MOE_FULL["N"], MOE_FULL["D"], MOE_FULL["E"]
    C = max(int(N * 1.25 / E), 1)
    x, router, dup = moe_case(dev, N, D, E, C)
    expert, pos, gate, _ = moe.moe_route(x, router, E)
    kept = int(((pos >= 0) & (pos < C)).sum())
    check(0 < kept < N, f"moe_route kept {kept} of {N} tokens")
    errs = {}
    for what, (e, p, g) in (("moe_route", (expert, pos, gate)),
                            ("duplicates", dup)):
        buf = mk.dispatch_to_experts(x, e, p, E, C)
        ref = mk.dispatch_reference(x, e, p, E, C)
        errs[f"dispatch_{what}"] = max_err(buf, ref)
        if what == "moe_route":
            check(torch.equal(buf, ref), f"moe dispatch ({what}): max_abs_err "
                  f"{errs[f'dispatch_{what}']}, not bit for bit")
        else:                # the JAX test's assert_allclose(1e-6, 1e-6)
            check(bool(((buf - ref).abs() <= 1e-6 + 1e-6 * ref.abs()).all()),
                  f"moe dispatch ({what}): max_abs_err "
                  f"{errs[f'dispatch_{what}']} beyond 1e-6 + 1e-6 |plain|")
        y = mk.combine_from_experts(buf, e, p, g)
        yref = mk.combine_reference(buf, e, p, g)
        errs[f"combine_{what}"] = max_err(y, yref)
        check(torch.equal(y, yref), f"moe combine ({what}): max_abs_err "
              f"{errs[f'combine_{what}']}, not bit for bit")
        del buf, ref, y, yref
    torch.cuda.synchronize()
    buf = mk.dispatch_to_experts(x, expert, pos, E, C)
    valid = (pos >= 0) & (pos < C)
    slot = expert.long() * C + pos.long()

    def index_add():
        out = torch.zeros((E * C + 1, D), device=dev)
        out.index_add_(0, torch.where(valid, slot, E * C), x)
        return out[:-1].view(E, C, D)

    def index_select():
        rows = buf.view(E * C, D).index_select(0, torch.where(valid, slot, 0))
        return rows * torch.where(valid, gate, 0.0)[:, None]

    check(torch.equal(index_add(), buf), "index_add_ yardstick disagrees")
    check(torch.equal(index_select(), mk.combine_reference(
        buf, expert, pos, gate)), "index_select yardstick disagrees")
    rows = {
        "moe_dispatch": dict(
            replaces="mxnet_tpu/pallas_ops/moe_kernels.py:90",
            fn=lambda: mk.dispatch_to_experts(x, expert, pos, E, C),
            plain=lambda: mk.dispatch_reference(x, expert, pos, E, C),
            library=index_add, library_name="torch.Tensor.index_add_ into a "
            "zeroed (E*C+1, D) buffer (dropped tokens to the extra row)",
            # expert and pos, the kept rows of x, all of buf
            nbytes=8 * N + 4 * kept * D + 4 * E * C * D, ops=0,
            max_abs_err=errs["dispatch_duplicates"]),
        "moe_combine": dict(
            replaces="mxnet_tpu/pallas_ops/moe_kernels.py:114",
            fn=lambda: mk.combine_from_experts(buf, expert, pos, gate),
            plain=lambda: mk.combine_reference(buf, expert, pos, gate),
            library=index_select, library_name="torch.index_select of the "
            "slot rows and a multiply by the gate (0 for dropped tokens)",
            # expert, pos and gate, the kept rows of buf, all of y
            nbytes=12 * N + 4 * kept * D + 4 * N * D, ops=kept * D,
            max_abs_err=errs["combine_duplicates"]),
    }
    out = {}
    for name, r in rows.items():
        b_ms, b_by = bound(r["nbytes"], r["ops"], F32_FLOPS)
        out[name] = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/moe_kernels.cu",
            replaces=r["replaces"], max_abs_err=r["max_abs_err"],
            errors=errs,
            error_is="gate: on moe_route's routing the kernel equals the "
                     "plain version (torch.equal), combine also on "
                     "duplicate routing; dispatch with duplicate slots "
                     "within 1e-6 + 1e-6 |plain| (max_abs_err: that case)",
            ms=device_ms(r["fn"], match="moe", skip=FLUSH_ONLY),
            event_ms=time_ms(r["fn"]),
            plain_ms=device_ms(r["plain"], iters=5, skip=FLUSH_ONLY),
            library_ms=device_ms(r["library"], skip=FLUSH_ONLY),
            library=r["library_name"], bound_ms=b_ms, bound_by=b_by,
            times_are="device time per call (torch.profiler, L2 flushed); "
                      "ms counts the kernels of the wrapper call (dispatch: "
                      "clear, route, gather, duplicate pass); event_ms: "
                      "CUDA events around the wrapper call",
            kept_tokens=kept,
            shapes=f"x ({N}, {D}) float32, expert/pos ({N},) int32, gate "
                   f"({N},) float32, buf ({E}, {C}, {D}) float32; "
                   "moe_route routing of a seeded router")
    return out


# ---------------------------------------------------------------------------
# phases 2-4: the port's entry points
# ---------------------------------------------------------------------------

_COUNTERS = {
    "flash_attention_fwd": ("flash_attention", "launches"),
    "flash_attention_dq": ("flash_attention", "launches_dq"),
    "flash_attention_dkv": ("flash_attention", "launches_dkv"),
    "paged_attention": ("paged_attention", "launches"),
    "lamb_pass1": ("fused_update", "launches_pass1"),
    "lamb_pass2": ("fused_update", "launches_pass2"),
    "adam_update": ("fused_update", "launches_adam"),
    "int8_matmul": ("int8_matmul", "launches"),
    "moe_dispatch": ("moe_kernels", "launches_dispatch"),
    "moe_combine": ("moe_kernels", "launches_combine"),
}


def _counter_module(mod):
    import importlib
    return importlib.import_module(f"mxnet_tpu_torch.cuda_ops.{mod}")


def reset_counts():
    for mod, attr in _COUNTERS.values():
        setattr(_counter_module(mod), attr, 0)


def expect(**launches):
    """Launch counts of a path: the given ones, 0 for every other kernel."""
    want = dict.fromkeys(_COUNTERS, 0)
    want.update(launches)
    return want


def read_counts():
    return {name: getattr(_counter_module(mod), attr)
            for name, (mod, attr) in _COUNTERS.items()}


def sync(model):
    import torch
    if model.device.type == "cuda":
        torch.cuda.synchronize()


def serving_phase(model, n_req=16, lo=16, hi=384, prefix=128, new=64,
                  slots=8, page_size=16, chunk=8, seed=0):
    """Staggered traffic: one request behind the shared prefix prefills
    first, then the rest arrive together (half of them behind the same
    prefix). Returns (requests, server stats, seconds)."""
    import numpy as np
    from mxnet_tpu_torch import serve
    rng = np.random.RandomState(seed)
    V = model.cfg["vocab_size"]
    shared = rng.randint(0, V, (prefix,)).astype(np.int32)
    specs = []
    for i in range(n_req):
        n = int(rng.randint(lo, hi + 1))
        if i % 2 == 0:
            tail = rng.randint(0, V, (max(n - prefix, 8),)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.randint(0, V, (n,)).astype(np.int32)
        sample = i % 4 >= 2
        specs.append((prompt, dict(max_new_tokens=new,
                                   temperature=0.8 if sample else 0.0,
                                   top_k=40 if sample else 0, seed=i)))
    srv = serve.Server(model, slots=slots, pages="on", page_size=page_size,
                       prefill_chunk=chunk)
    sync(model)
    t0 = time.perf_counter()
    reqs = [srv.submit(specs[0][0], **specs[0][1])]
    while srv.busy() and srv.stats()["tree_nodes"] == 0:
        srv.step()
    reqs += [srv.submit(p, **kw) for p, kw in specs[1:]]
    srv.drain()
    sync(model)
    seconds = time.perf_counter() - t0
    stats = srv.stats()
    srv.stop()
    return reqs, stats, seconds


def context_fill_phase(model, chunk=8):
    """A request that fills the whole context decodes its last positions
    while a peer in the same 1024 bucket prefills: each chunk round steps
    the decoder C times, so its masked steps pass position max_length-1
    (the position table is read clamped, as in the JAX package)."""
    import numpy as np
    from mxnet_tpu_torch import serve
    V, L = model.cfg["vocab_size"], model.cfg["max_length"]
    rng = np.random.RandomState(4)
    srv = serve.Server(model, slots=8, pages="on", page_size=16,
                       prefill_chunk=chunk)
    a = srv.submit(rng.randint(0, V, (L - 24,)).astype(np.int32),
                   max_new_tokens=24)
    while len(a.tokens) < 16:
        srv.step()
    b = srv.submit(rng.randint(0, V, (L // 2 + 8,)).astype(np.int32),
                   max_new_tokens=4)
    srv.drain()
    srv.stop()
    check(a.verdict == b.verdict == "200 ok",
          f"context-fill verdicts {a.verdict!r} {b.verdict!r}")
    check(len(a.tokens) == 24 and len(b.tokens) == 4,
          "context-fill token counts")
    check(all(0 <= x < V for x in a.tokens + b.tokens),
          "context-fill tokens out of the vocabulary")


def serve_tokens(model, prompts, new, pages, page_size=16, chunk=8):
    from mxnet_tpu_torch import serve
    srv = serve.Server(model, slots=4, pages=pages, page_size=page_size,
                       prefill_chunk=chunk)
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    srv.drain()
    srv.stop()
    check(all(r.verdict == "200 ok" for r in reqs),
          f"pages={pages} verdicts {[r.verdict for r in reqs]}")
    return [list(r.tokens) for r in reqs]


def breakdown_phase(model, n_req=8, prompt=64, new=40, rounds=8):
    """Where a steady decode round's time goes: 8 requests past their
    prefill, `rounds` one-token rounds timed bare, then the same number
    under torch.profiler for device busy time and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import serve
    rng = np.random.RandomState(3)
    srv = serve.Server(model, slots=n_req, pages="on", page_size=16,
                       prefill_chunk=8)
    for _ in range(n_req):
        srv.submit(rng.randint(0, model.cfg["vocab_size"], (prompt,))
                   .astype(np.int32), max_new_tokens=new)
    while srv.stats()["tokens"] < n_req:             # every prompt prefilled
        srv.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        srv.step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            srv.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / rounds
    srv.drain()
    srv.stop()
    busy_ms, top, _ = device_profile(prof, rounds, 6)
    # kernel times do not grow under the profiler; the round's wall does,
    # so the idle share is taken against the bare round
    return {"decode_round_ms": bare_ms, "profiled_round_ms": prof_ms,
            "device_busy_ms_per_round": busy_ms,
            "device_idle_share": None if busy_ms is None
            else 1 - busy_ms / bare_ms,
            "slots": n_req, "context": f"{prompt}..{prompt + new}",
            "top_device_ms_per_round": top}


def _kernel_class(name):
    if "mxt::" in name:
        for part in ("lamb", "adam", "int8", "moe"):
            if part in name:
                return f"{part} kernels"
        return "attention kernels"
    if "gemm" in name or name.startswith(("nvjet", "cutlass")):
        return "gemm"
    return "other"


def device_profile(prof, per, n_top):
    """(device busy ms, top kernels {name: ms}, ms by class) per `per`
    repetitions of a torch.profiler window. Kernel rows only: an op row's
    self device time repeats its kernels'. Names are cut to 70
    characters and kernels whose cut names agree are summed."""
    by_name, by_class = {}, {}
    for key, us in kernel_times(prof).items():
        ms = us / 1e3 / per
        by_name[key[:70]] = by_name.get(key[:70], 0.0) + ms
        cls = _kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    if not by_name:
        return None, {}, {}
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return sum(by_name.values()), dict(top[:n_top]), by_class


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")


def build_bert(cfg, seed, device):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert
    model = bert.BERTForPretraining(cfg, device=device)
    model.initialize(generator=mxrandom.seed(seed, device))
    return model


def training_phase(dev, batch=32, seq_len=512, masked=76, warmup=2,
                   steps=16):
    """BERT-base pretraining steps on one repeated synthetic batch (the
    JAX package's bench.py configuration). Returns the result dict and
    the launch counts of the timed steps. The NSP term of a fresh model
    swings by tenths over the first steps while the MLM term falls
    steadily, so the run is long enough for the last loss to sit clearly
    below the first."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(dtype="bfloat16")
    model = build_bert(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(
        model, bert.bert_pretrain_loss, "lamb",
        {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    losses = [trainer.step(data, labels) for _ in range(warmup)]
    float(losses[-1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(data, labels))
    float(losses[-1])                         # one host fetch fences all
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(np.isfinite(losses).all(), f"training losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = expect(flash_attention_fwd=12 * steps,
                  flash_attention_dq=12 * steps,
                  flash_attention_dkv=12 * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"training launches {counts} != {want}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        float(trainer.step(data, labels))
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy_ms, top, by_class = device_profile(prof, 1, 10)
    step_ms = secs * 1e3 / steps
    res = {"model": "bert_base_config(dtype='bfloat16')", "batch": batch,
           "seq_len": seq_len, "masked": masked, "steps": steps,
           "warmup": warmup, "seconds": secs,
           "tokens_per_s": batch * seq_len * steps / secs,
           "ms_per_step": step_ms,
           "max_memory_allocated_bytes": peak,
           "param_count": trainer.param_count, "losses": losses,
           "profiled_step_ms": prof_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": None if busy_ms is None
           else 1 - busy_ms / step_ms,
           "device_ms_per_step_by_class": by_class,
           "top_device_ms_per_step": top}
    del trainer, model
    torch.cuda.empty_cache()
    return res, counts


def train_parity_phase(dev, steps=3):
    """A small float32 BERT (dropout 0) trained `steps` LAMB steps on the
    card (flash fwd/dq/dkv and both LAMB kernels) and on the CPU (plain
    versions) from the same weights: losses and the final flat master
    must agree within TOL_TRAIN."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(num_layers=2, units=256, hidden_size=1024,
                                num_heads=4, max_length=128, dropout=0.0)
    b = bert.make_synthetic_batch(cfg, 8, 128, 20, seed=2)
    b["valid_length"][::2] = 100
    out = {}
    for where in ("cpu", "cuda"):
        model = build_bert(cfg, 5, "cpu")
        model.to(where)
        tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01},
                                     device=where)
        reset_counts()
        losses = [float(tr.step([b[k] for k in _DATA],
                                [b[k] for k in _LABELS]))
                  for _ in range(steps)]
        counts = read_counts()
        out[where] = (losses, tr.params.cpu(), counts)
    lc, wc, _ = out["cpu"]
    lg, wg, counts = out["cuda"]
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max_err(wg, wc)
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"card vs CPU training: losses {lg} vs {lc}, master err {e_w}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=L * steps,
                  flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"parity launches {counts} != {want}")
    check(all(v == 0 for v in out["cpu"][2].values()),
          f"CPU run launched kernels {out['cpu'][2]}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_master_err": e_w, "master_elements": int(wg.numel())}


# ---------------------------------------------------------------------------
# phases 8-10: GPT-2 pretraining with Adam, then int8 serving
# ---------------------------------------------------------------------------

_GPT_DATA = ("input_ids", "valid_length")
_GPT_LABELS = ("labels", "weights")


def gpt_pretrain_phase(dev, batch=16, seq_len=1024, warmup=2, steps=16,
                       lr=1e-3, **cfg_overrides):
    """GPT-2 117M pretraining steps with Adam on one repeated synthetic
    batch (examples/gpt/pretrain.py's optimizer and learning rate; the
    16,384 tokens per step of phase 6). Returns the result dict, the
    launch counts of the timed steps, the model and its trainer."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(dtype="bfloat16", **cfg_overrides)
    model = build_model(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(model, gpt.gpt_lm_loss, "adam",
                                      {"learning_rate": lr}, device=dev)
    n_params = len(trainer.params)
    b = gpt.make_synthetic_batch(cfg, batch, seq_len, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _GPT_DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _GPT_LABELS]
    losses = [trainer.step(data, labels) for _ in range(warmup)]
    float(losses[-1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(data, labels))
    float(losses[-1])                         # one host fetch fences all
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(np.isfinite(losses).all(), f"GPT-2 training losses {losses}")
    check(losses[-1] < losses[0], f"GPT-2 loss did not fall: {losses}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps,
                  adam_update=n_params * steps)
    check(counts == want, f"GPT-2 training launches {counts} != {want}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        float(trainer.step(data, labels))
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy_ms, top, by_class = device_profile(prof, 1, 10)
    step_ms = secs * 1e3 / steps
    res = {"model": "gpt2_117m_config(dtype='bfloat16')", "batch": batch,
           "seq_len": seq_len, "steps": steps, "warmup": warmup,
           "optimizer": f"adam lr {lr}", "seconds": secs,
           "tokens_per_s": batch * seq_len * steps / secs,
           "ms_per_step": step_ms,
           "max_memory_allocated_bytes": peak,
           "param_count": trainer.param_count,
           "trainable_parameters": n_params, "losses": losses,
           "profiled_step_ms": prof_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": None if busy_ms is None
           else 1 - busy_ms / step_ms,
           "adam_share_of_device_time": None if busy_ms is None
           else by_class.get("adam kernels", 0.0) / busy_ms,
           "device_ms_per_step_by_class": by_class,
           "top_device_ms_per_step": top}
    return res, counts, model, trainer


def adam_parity_phase(dev, steps=3):
    """A small float32 GPT (dropout 0) trained `steps` Adam steps, and from
    the same start `steps` AdamW steps (wd 0.01, clip 1.0), on the card
    (flash and Adam kernels) and on the CPU (plain versions): losses and
    every parameter must agree within TOL_TRAIN."""
    import numpy as np
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(num_layers=2, units=256, hidden_size=1024,
                               num_heads=4, max_length=128, dropout=0.0)
    b = gpt.make_synthetic_batch(cfg, 8, 128, seed=2)
    b["valid_length"][::2] = 100
    b["weights"][::2, 100:] = 0.0
    out = {}
    for kind, opts in (("adam", {"learning_rate": 1e-3}),
                       ("adamw", {"learning_rate": 1e-3, "wd": 0.01,
                                  "clip_gradient": 1.0})):
        runs = {}
        for where in ("cpu", dev):
            model = build_model(cfg, 5, "cpu")
            model.to(where)
            tr = parallel.ShardedTrainer(model, gpt.gpt_lm_loss, kind,
                                         dict(opts), device=where)
            reset_counts()
            losses = [float(tr.step([b[k] for k in _GPT_DATA],
                                    [b[k] for k in _GPT_LABELS]))
                      for _ in range(steps)]
            runs[str(where)] = (losses, [p.cpu() for p in tr.params],
                                read_counts(), len(tr.params))
        (lc, wc, cc, _), (lg, wg, counts, n) = runs["cpu"], runs[str(dev)]
        e_loss = float(np.abs(np.subtract(lg, lc)).max())
        e_w = max(max_err(a, c) for a, c in zip(wg, wc))
        check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
              f"card vs CPU {kind}: losses {lg} vs {lc}, param err {e_w}")
        L = cfg["num_layers"]
        want = expect(flash_attention_fwd=L * steps,
                      flash_attention_dq=L * steps,
                      flash_attention_dkv=L * steps, adam_update=n * steps)
        check(counts == want, f"{kind} parity launches {counts} != {want}")
        check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
        out[kind] = {"losses_card": lg, "losses_cpu": lc,
                     "max_loss_err": e_loss, "max_param_err": e_w}
    return out


def int8_serving_phase(model, bf16_serving):
    """Phase 8's trained model (its weights written back), quantized to
    int8 with scales calibrated on the first 128 tokens of two training
    batches, serving phase 2's traffic; every Dense runs the int8
    kernel, 48 launches per one-token model step, which the phase counts
    itself. Then one `generate` call (its prefill reaches the kernel at
    M = 4 x 128) and a profiled steady decode round."""
    import numpy as np
    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import gpt
    cfg = model.cfg
    calib = [gpt.make_synthetic_batch(cfg, 16, 1024, seed=s)["input_ids"]
             [:, :128] for s in (0, 1)]
    quant.quantize_block(model, calib_data=calib)
    n_dense = sum(isinstance(m, quant.QuantizedDense)
                  for m in model.modules())
    check(n_dense == 4 * cfg["num_layers"], f"{n_dense} int8 layers")
    check(all(m._act_scale is not None for m in model.modules()
              if isinstance(m, quant.QuantizedDense)),
          "a layer was not calibrated")
    token_steps = [0]
    chunk = model.decode_paged_chunk

    def counted(toks, *args):
        token_steps[0] += toks.shape[1]
        return chunk(toks, *args)

    model.decode_paged_chunk = counted
    reset_counts()
    reqs, stats, secs = serving_phase(model)
    counts = read_counts()
    del model.decode_paged_chunk
    check(all(r.verdict == "200 ok" for r in reqs),
          f"int8 verdicts {[r.verdict for r in reqs]}")
    check(all(len(r.tokens) == 64 for r in reqs), "int8 token counts")
    check(counts["int8_matmul"] == n_dense * token_steps[0],
          f"int8 launches {counts['int8_matmul']} != {n_dense} x "
          f"{token_steps[0]} one-token steps")
    check(counts["paged_attention"] > 0, "paged kernel never launched")
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    res = {"requests": len(reqs), "tokens": n_tok, "seconds": secs,
           "tokens_per_s": n_tok / secs,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "prefix_hit_rate": stats["prefix_hit_rate"],
           "one_token_model_steps": token_steps[0],
           "launches": counts,
           "bf16_tokens_per_s": bf16_serving["tokens_per_s"],
           "bf16_ttft_ms_p50": bf16_serving["ttft_ms_p50"],
           "bf16_ttft_ms_p99": bf16_serving["ttft_ms_p99"]}
    gp = np.random.RandomState(2).randint(0, 50257, (4, 100)).astype(np.int32)
    reset_counts()
    toks = model.generate(gp, max_new_tokens=32)
    counts = read_counts()
    check(toks.shape == (4, 32) and (toks >= 0).all()
          and (toks < 50257).all(), f"int8 generate tokens {toks.shape}")
    # one prefill pass (M = 4 x 128 rows) and 31 one-token steps
    check(counts["int8_matmul"] == n_dense * 32
          and counts["flash_attention_fwd"] == cfg["num_layers"],
          f"int8 generate launches {counts}")
    res["generate_launches"] = counts
    res["breakdown"] = breakdown_phase(model)
    return res


def int8_narrow_phase(dev, new=16):
    """A float32 GPT of 2 layers x 256 units and gpt_tiny's vocabulary of
    128: the int8 server's greedy tokens equal its simulate=True twin's
    (the JAX package's gate, `Server(model, slots=2)`,
    tests/unittest/test_serve.py), and one quantized forward on `dev`
    agrees with the same forward on the CPU.

    The vocabulary is gpt_tiny's because the gate needs logit margins
    wider than the activation-quantization error: with GPT-2's 50257
    tokens the flat logits of random weights put near-ties at almost
    every step (on the CPU plain versions, 6 of 6 seeds left the
    simulate twin's tokens within 64 tokens; at vocabulary 128, 1 of 6).

    The serving gate runs the JAX gate's model, whose biases start at 0.
    The forward runs the same weights with every Dense bias drawn nonzero
    (0.05 x randn), so the int8 kernel's bias epilogue takes part in it.

    Tolerance of the forward: TOL_INT8_FWD of the largest |logit|. The
    int8 products are exact on both devices, but the float32 LayerNorm,
    attention and head around them round differently on the card, and a
    one-ulp difference can move an activation across a rounding boundary
    of the int8 grid, which moves that layer's output by one grid step
    (max|x|/127) times a weight. The phase measures that effect on the
    CPU and reports it (`perturbed_rel`): the same forward with every
    LayerNorm gain scaled by (1 + 2e-7), two float32 ulps."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import serve, weights
    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(num_layers=2, units=256, hidden_size=1024,
                               num_heads=4, max_length=128, dropout=0.0,
                               vocab_size=128)
    base = build_model(cfg, 0, "cpu")
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    brng = np.random.RandomState(7)
    biased = {k: (brng.randn(*a.shape) * 0.05).astype(np.float32)
              if k.endswith(".bias") else a for k, a in sorted(arrays.items())}

    def twin(where, simulate, arrays=arrays):
        m = gpt.GPTForCausalLM(cfg, device=where)
        weights.load_named_arrays(m, arrays)
        return quant.quantize_block(m, simulate=simulate)

    qm, sm = twin(dev, False), twin(dev, True)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (5, 9, 3, 17)]
    toks = {}
    reset_counts()
    for name, m in (("int8", qm), ("simulate", sm)):
        srv = serve.Server(m, slots=2)
        reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
        srv.drain()
        srv.stop()
        check(all(r.verdict == "200 ok" for r in reqs),
              f"narrow {name} verdicts {[r.verdict for r in reqs]}")
        toks[name] = [list(r.tokens) for r in reqs]
        if name == "int8":
            n_int8 = read_counts()["int8_matmul"]
    check(toks["int8"] == toks["simulate"],
          f"int8 tokens {toks['int8']} != simulate {toks['simulate']}")
    check(str(dev) == "cpu" or n_int8 > 0, "int8 kernel never launched")
    ids = torch.from_numpy(rng.randint(0, 128, (2, 64)).astype(np.int32))
    perturbed = {k: a * np.float32(1 + 2e-7) if k.endswith(".gamma") else a
                 for k, a in biased.items()}
    with torch.no_grad():
        got = twin(dev, False, biased)(ids.to(dev)).cpu()
        ref = twin("cpu", False, biased)(ids)
        pert = twin("cpu", False, perturbed)(ids)
    err = max_err(got, ref)
    scale = float(ref.abs().max())
    check(err <= TOL_INT8_FWD * scale,
          f"quantized forward card vs CPU: {err} > {TOL_INT8_FWD} x {scale}")
    return {"tokens_equal_simulate": True, "tokens": toks["int8"],
            "forward_max_abs_err": err, "forward_max_abs_logit": scale,
            "forward_rel": err / scale, "tol_rel": TOL_INT8_FWD,
            "perturbed_rel": max_err(pert, ref) / scale,
            "int8_launches_in_serving": n_int8}


# ---------------------------------------------------------------------------
# phases 11-12: the Switch-FFN mixture-of-experts LM
# ---------------------------------------------------------------------------

SWITCH_FULL = dict(V=50257, D=768, F=3072, E=8)   # GPT-2 vocab; Switch-Base-8


def switch_batch(V, B, T, seed=0):
    """The JAX package's `_dryrun_moe` batch: random tokens, labels the
    tokens rolled by one position."""
    import numpy as np
    toks = np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)
    return toks, np.roll(toks, 1, axis=1).astype(np.int32)


def switch_routing(trainer, toks, E, capacity_factor=1.25):
    """(expert, pos, capacity) of the trainer's current embedding and
    router on a batch, as `moe_ffn` routes it."""
    import torch
    from mxnet_tpu_torch.parallel import moe
    p = dict(zip(trainer._names, trainer.params))
    with torch.no_grad():
        h = p["embed.weight"][torch.as_tensor(toks, device=trainer.device)
                              .long()].reshape(-1, p["router_w"].shape[0])
        expert, pos, _, _ = moe.moe_route(h, p["router_w"], E)
    return expert, pos, max(int(h.shape[0] * capacity_factor / E), 1)


def switch_phase(dev, batch=16, seq_len=1024, warmup=2, steps=16, lr=1e-3,
                 **widths):
    """The Switch-FFN LM at full width (GPT-2's vocabulary, Switch-Base's
    d_model 768 and d_ff 3072, 8 experts, capacity factor 1.25, tanh
    gelu, bf16 parameters with the MoE math in float32) trained through
    `ShardedTrainer(..., "adam", {"learning_rate": 1e-3})` (the JAX
    package's `_dryrun_moe` optimizer) on one repeated batch: 2 warm-up
    steps, 16 timed steps ended by one host fetch, one profiled step.
    Returns the result dict and the launch counts of the timed steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import parallel
    w = dict(SWITCH_FULL, **widths)
    model = build_switch_lm(**w, dtype="bfloat16", seed=0, device=dev)
    trainer = parallel.ShardedTrainer(model, switch_lm_loss, "adam",
                                      {"learning_rate": lr}, device=dev)
    toks, labels = switch_batch(w["V"], batch, seq_len)
    data = [torch.from_numpy(toks).to(dev)]
    lab = [torch.from_numpy(labels).to(dev)]
    _, pos0, C = switch_routing(trainer, toks, w["E"])
    losses = [trainer.step(data, lab) for _ in range(warmup)]
    float(losses[-1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(data, lab))
    float(losses[-1])                         # one host fetch fences all
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(np.isfinite(losses).all(), f"Switch LM losses {losses}")
    check(losses[-1] < losses[0], f"Switch LM loss did not fall: {losses}")
    n_params = len(trainer.params)
    want = expect(moe_dispatch=2 * steps, moe_combine=3 * steps,
                  adam_update=n_params * steps)
    check(n_params == 6 and counts == want,
          f"Switch LM launches {counts} != {want} ({n_params} parameters)")
    expert, pos, _ = switch_routing(trainer, toks, w["E"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        float(trainer.step(data, lab))
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy_ms, top, by_class = device_profile(prof, 1, 10)
    step_ms = secs * 1e3 / steps
    return {"model": "Switch-FFN LM " + json.dumps(w) + ", bf16",
            "batch": batch, "seq_len": seq_len, "capacity": C,
            "steps": steps, "warmup": warmup, "optimizer": f"adam lr {lr}",
            "seconds": secs,
            "tokens_per_s": batch * seq_len * steps / secs,
            "ms_per_step": step_ms, "max_memory_allocated_bytes": peak,
            "param_count": trainer.param_count, "losses": losses,
            "dropped_share_first_step": float((pos0 >= C).float().mean()),
            "dropped_share_last_step": float((pos >= C).float().mean()),
            "tokens_per_expert_last_step":
                torch.bincount(expert.long(), minlength=w["E"]).tolist(),
            "profiled_step_ms": prof_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": None if busy_ms is None
            else 1 - busy_ms / step_ms,
            "moe_share_of_device_time": None if busy_ms is None
            else by_class.get("moe kernels", 0.0) / busy_ms,
            "device_ms_per_step_by_class": by_class,
            "top_device_ms_per_step": top}, counts


def switch_parity_phase(dev, steps=3, batch=16, seq_len=64, cf=1.0):
    """A small float32 Switch LM (V 128, D 64, F 128, E 4, capacity
    factor 1.0, so that a few tokens overflow) trained `steps` Adam steps
    on the card (dispatch, combine and Adam kernels) and on the CPU
    (plain versions) from the same weights: the routing of every step is
    equal, and losses and every parameter agree within TOL_TRAIN."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel, weights
    w = dict(V=128, D=64, F=128, E=4)
    base = build_switch_lm(**w, seed=5, device="cpu", capacity_factor=cf)
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    toks, labels = switch_batch(w["V"], batch, seq_len, seed=1)
    runs = {}
    for where in ("cpu", dev):
        model = build_switch_lm(**w, seed=5, device=where,
                                capacity_factor=cf)
        weights.load_named_arrays(model, arrays)
        tr = parallel.ShardedTrainer(model, switch_lm_loss, "adam",
                                     {"learning_rate": 1e-3}, device=where)
        reset_counts()
        losses, routes = [], []
        for _ in range(steps):
            expert, pos, C = switch_routing(tr, toks, w["E"], cf)
            routes.append((expert.cpu(), pos.cpu()))
            losses.append(float(tr.step([toks], [labels])))
        runs[str(where)] = (losses, [p.cpu() for p in tr.params], routes,
                            read_counts())
    (lc, wc, rc, cc), (lg, wg, rg, counts) = runs["cpu"], runs[str(dev)]
    check(all(torch.equal(a, b) for ra, rb in zip(rg, rc)
              for a, b in zip(ra, rb)), "card vs CPU Switch LM routing differs")
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max(max_err(a, c) for a, c in zip(wg, wc))
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"card vs CPU Switch LM: losses {lg} vs {lc}, param err {e_w}")
    want = expect(moe_dispatch=2 * steps, moe_combine=3 * steps,
                  adam_update=6 * steps)
    check(counts == want, f"Switch LM parity launches {counts} != {want}")
    check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_param_err": e_w, "routing_equal": True,
            "capacity": C, "dropped_share_per_step":
                [float((p >= C).float().mean()) for _, p in rg]}


def build_switch_lm(V, D, F, E, dtype="float32", seed=0, device=None,
                    capacity_factor=1.25):
    """The Switch-FFN LM of the JAX package's `_dryrun_moe`
    (__graft_entry__.py), composed of the port's gluon blocks: an
    embedding, `h + moe_apply(h)` with E experts of width F, and a Dense
    head; forward returns (logits, aux_loss). Weights: uniform(0.07)
    (the JAX model's default initializer; the head's bias 0)."""
    from mxnet_tpu_torch import context, gluon, parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import nn

    class SwitchLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, D, dtype=dtype)
            self.router_w = gluon.Parameter("router_w", (D, E), dtype)
            self.moe_w1 = gluon.Parameter("moe_w1", (E, D, F), dtype)
            self.moe_w2 = gluon.Parameter("moe_w2", (E, F, D), dtype)
            self.head = nn.Dense(V, in_units=D, flatten=False, dtype=dtype)

        def forward(self, toks):
            h = self.embed(toks)
            B, T, _ = h.shape
            y, aux = parallel.moe_apply(h.reshape(B * T, D), self.router_w,
                                        self.moe_w1, self.moe_w2,
                                        capacity_factor=capacity_factor)
            return self.head(h + y.reshape(B, T, D)), aux

    dev = context.resolve(device)
    with dev:
        model = SwitchLM()
    model.initialize(generator=mxrandom.seed(seed, dev))
    return model


def switch_lm_loss(logits, aux, labels):
    """Mean token cross entropy (float32 log-softmax) + 0.01 x aux."""
    import torch
    logp = torch.log_softmax(logits.float(), -1)
    ce = -logp.gather(-1, labels.long()[..., None]).mean()
    return ce + 0.01 * aux


def build_model(cfg, seed, device=None):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import gpt
    model = gpt.GPTForCausalLM(cfg, device=device)
    model.initialize(generator=mxrandom.seed(seed, model.device))
    return model


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("chip_smoke: TF32 off for float32 matmuls and convolutions")
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.models import gpt
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"chip_smoke: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # 1. kernels against their plain versions
    kernels = {"paged_attention": paged_phase(dev),
               "flash_attention_fwd": flash_phase(dev)}
    kernels.update(train_flash_phase(dev))
    for row, extra in gpt_flash_phase(dev).items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at GPT-2 training's shape "
              + json.dumps(extra["gpt2_train_shape"]))
    kernels.update(lamb_phase(dev))
    kernels.update(adam_phase(dev))
    kernels.update(int8_phase(dev))
    kernels.update(moe_phase(dev))
    for k in kernels.values():
        lib = "none" if k["library_ms"] is None \
            else f"{k['library_ms']:.4f} ms"
        print(f"chip_smoke: {k['name']}: err {k['max_abs_err']:.3g}; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {lib}, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")

    # 2. serving at full width, bfloat16
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16"), seed=0)
    reset_counts()
    reqs, stats, secs = serving_phase(model)
    counts = read_counts()
    print(f"chip_smoke: serving launches {counts}")
    check(all(r.verdict == "200 ok" for r in reqs),
          f"verdicts {[r.verdict for r in reqs]}")
    check(all(len(r.tokens) == 64 for r in reqs), "token counts")
    check(counts["paged_attention"] > 0, "paged kernel never launched")
    check(stats["prefix_hit_rate"] > 0, f"prefix_hit_rate {stats}")
    kernels["paged_attention"]["launches"] = counts["paged_attention"]
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    serving = {"requests": len(reqs), "tokens": n_tok, "seconds": secs,
               "tokens_per_s": n_tok / secs,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p99": float(np.percentile(ttft, 99)),
               "prefix_hit_rate": stats["prefix_hit_rate"],
               "chunk_dispatches": stats["chunk_dispatches"],
               "prompt_tokens": stats["prompt_tokens"]}
    print("chip_smoke: serving " + json.dumps(serving))
    reset_counts()
    context_fill_phase(model)
    check(read_counts()["paged_attention"] > 0,
          "paged kernel never launched in the context-fill run")
    print("chip_smoke: a context-filling request beside a prefilling peer "
          "served 200 ok")

    # 3. pages="on" == pages="off" in float32
    model32 = build_model(gpt.gpt2_117m_config(), seed=1)
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, 50257, (4, 50)).astype(np.int32)
    reset_counts()
    on = serve_tokens(model32, prompts, 16, "on")
    check(read_counts()["paged_attention"] > 0,
          "paged kernel never launched in the float32 run")
    off = serve_tokens(model32, prompts, 16, "off")
    check(on == off, f"pages on {on} != off {off}")
    print("chip_smoke: float32 pages=on tokens == pages=off tokens")

    # 4. generate: flash prefill
    gp = np.random.RandomState(2).randint(0, 50257, (4, 100)).astype(np.int32)
    sync(model)
    reset_counts()
    t0 = time.perf_counter()
    toks = model.generate(gp, max_new_tokens=32)
    sync(model)
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"chip_smoke: generate launches {counts}, {toks.size / gen_s:.1f} "
          "tokens/s")
    check(toks.shape == (4, 32) and (toks >= 0).all()
          and (toks < 50257).all(), f"generate tokens {toks.shape}")
    check(counts["flash_attention_fwd"] > 0, "flash kernel never launched")
    kernels["flash_attention_fwd"]["launches"] = counts["flash_attention_fwd"]
    reset_counts()
    gen32 = model32.generate(prompts, max_new_tokens=16)
    check(read_counts()["flash_attention_fwd"] > 0,
          "flash kernel never launched in the float32 generate")
    check(gen32.tolist() == off, f"generate {gen32.tolist()} != serve {off}")
    print("chip_smoke: float32 generate tokens == pages=off server tokens")

    # 5. where a steady decode round's time goes
    br = breakdown_phase(model)
    print("chip_smoke: breakdown " + json.dumps(br))
    del model, model32
    torch.cuda.empty_cache()

    # 6. BERT-base pretraining steps
    train, counts = training_phase(dev)
    print("chip_smoke: training " + json.dumps(train))
    print(f"chip_smoke: training launches {counts}")
    kernels["flash_attention_fwd_dropout"]["launches"] = \
        counts["flash_attention_fwd"]
    for name in ("flash_attention_dq", "flash_attention_dkv", "lamb_pass1",
                 "lamb_pass2"):
        kernels[name]["launches"] = counts[name]

    # 7. float32 training on the card == on the CPU
    parity = train_parity_phase(dev)
    print("chip_smoke: card-vs-CPU training " + json.dumps(parity))

    # 8. GPT-2 117M pretraining steps with Adam
    gtrain, counts, gmodel, gtrainer = gpt_pretrain_phase(dev)
    print("chip_smoke: GPT-2 training " + json.dumps(gtrain))
    print(f"chip_smoke: GPT-2 training launches {counts}")
    kernels["adam_update"]["launches"] = counts["adam_update"]

    # 9. float32 Adam and AdamW on the card == on the CPU
    aparity = adam_parity_phase(dev)
    print("chip_smoke: card-vs-CPU Adam/AdamW " + json.dumps(aparity))

    # 10. the trained model, quantized to int8, serving
    gtrainer.sync_to_block()
    del gtrainer
    torch.cuda.empty_cache()
    qserve = int8_serving_phase(gmodel, serving)
    del gmodel
    torch.cuda.empty_cache()
    print("chip_smoke: int8 serving " + json.dumps(qserve))
    kernels["int8_matmul"]["launches"] = qserve["launches"]["int8_matmul"]
    narrow = int8_narrow_phase(dev)
    print("chip_smoke: int8 float32 narrow model " + json.dumps(narrow))

    # 11. the Switch-FFN LM at full width, Adam
    switch, counts = switch_phase(dev)
    torch.cuda.empty_cache()
    print("chip_smoke: Switch LM training " + json.dumps(switch))
    print(f"chip_smoke: Switch LM training launches {counts}")
    for name in ("moe_dispatch", "moe_combine"):
        kernels[name]["launches"] = counts[name]

    # 12. a float32 Switch LM on the card == on the CPU
    sparity = switch_parity_phase(dev)
    print("chip_smoke: card-vs-CPU Switch LM " + json.dumps(sparity))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
