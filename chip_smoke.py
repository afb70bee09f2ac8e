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
     and holds losses and the final flat master against each other.

Phase 1 also holds the training kernels against their plain versions at
the training shapes: the flash forward with dropout 0.1 (its keep mask
bit for bit), the dq and dkv backward kernels over a grid of dtypes,
masks, causality and dropout, and both LAMB passes at BERT-base's flat
master size.

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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
F32_FLOPS = 67e12                  # float32 outside the tensor cores


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
}


def _counter_module(mod):
    import importlib
    return importlib.import_module(f"mxnet_tpu_torch.cuda_ops.{mod}")


def reset_counts():
    for mod, attr in _COUNTERS.values():
        setattr(_counter_module(mod), attr, 0)


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
        return "lamb kernels" if "lamb" in name else "attention kernels"
    if "gemm" in name or name.startswith(("nvjet", "cutlass")):
        return "gemm"
    return "other"


def device_profile(prof, per, n_top):
    """(device busy ms, top kernels {name: ms}, ms by class) per `per`
    repetitions of a torch.profiler window. Kernel rows only: an op row's
    self device time repeats its kernels'. Names are cut to 70
    characters and kernels whose cut names agree are summed."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    by_name, by_class = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and dev_us(e) > 0:
            ms = dev_us(e) / 1e3 / per
            by_name[e.key[:70]] = by_name.get(e.key[:70], 0.0) + ms
            cls = _kernel_class(e.key)
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
    want = {"flash_attention_fwd": 12 * steps, "flash_attention_dq":
            12 * steps, "flash_attention_dkv": 12 * steps,
            "lamb_pass1": steps, "lamb_pass2": steps, "paged_attention": 0}
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
    want = {"flash_attention_fwd": L * steps, "flash_attention_dq": L * steps,
            "flash_attention_dkv": L * steps, "lamb_pass1": steps,
            "lamb_pass2": steps, "paged_attention": 0}
    check(counts == want, f"parity launches {counts} != {want}")
    check(all(v == 0 for v in out["cpu"][2].values()),
          f"CPU run launched kernels {out['cpu'][2]}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_master_err": e_w, "master_elements": int(wg.numel())}


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
    kernels.update(lamb_phase(dev))
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
