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
     torch.profiler (device busy time, top kernels).

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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak


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


# ---------------------------------------------------------------------------
# phases 2-4: the port's entry points
# ---------------------------------------------------------------------------

def reset_counts():
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    fa.launches = 0
    pa.launches = 0


def read_counts():
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    return {"flash_attention_fwd": fa.launches,
            "paged_attention": pa.launches}


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
    from torch.autograd import DeviceType
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernel rows only: an op row's self device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / rounds
    top = sorted(events, key=dev_us, reverse=True)[:6]
    # kernel times do not grow under the profiler; the round's wall does,
    # so the idle share is taken against the bare round
    return {"decode_round_ms": bare_ms, "profiled_round_ms": prof_ms,
            "device_busy_ms_per_round": busy_ms if events else None,
            "device_idle_share": (1 - busy_ms / bare_ms) if events else None,
            "slots": n_req, "context": f"{prompt}..{prompt + new}",
            "top_device_ms_per_round": {
                e.key[:60]: dev_us(e) / 1e3 / rounds for e in top}}


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
    for k in kernels.values():
        print(f"chip_smoke: {k['name']}: err bf16 {k['max_abs_err']:.3g} "
              f"f32 {k['max_abs_err_f32']:.3g}; kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']:.4f}"
              f" ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

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
