// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++: the
// dq kernel and the dkv kernel.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// mxnet_tpu/pallas_ops/flash_attention.py (launched by `_flash_bwd_pallas`).
// With the forward's residuals (O's row log-sum-exp `lse`) and
// delta = rowsum(dO * O) (plain torch, as the JAX package computes it
// outside Pallas), each score tile is rebuilt from q and k:
//   p  = exp(q.k^T * sm_scale + bias - lse)      (causal: masked -> -1e30)
//   dp = dO.v^T, dropped and scaled by 1/(1-p) where the keep mask drops
//   ds = p * (dp - delta) * sm_scale, rounded to the input dtype
//   dq = sum_k ds.k            (dq kernel: a block per 128 query rows at
//                               D <= 64, 64 at D <= 128 (f32); a
//                               warpgroup per 64 rows (bf16))
//   dv = sum_q p~^T.dO, dk = sum_q ds^T.q
//                              (dkv kernel: the same in keys)
// where p~ is p dropped and scaled, rounded to the input dtype. The split
// into two kernels is the TPU design: each output tile is owned by one
// block, so there are no atomics and the result is deterministic. Keep bits
// are the coordinate-keyed Philox of dropout.cuh, identical to the
// forward's whatever the tiling. Ragged Lq and Lk are masked in the kernel;
// a causal dq block stops at the last key tile its rows can see, a causal
// dkv block starts at the first q tile that can see its keys (the offset
// Lk - Lq aligns the last query with the last key, as the forward does).
//
// What bounds it: about 4*Lq*Lk*D operations per kernel per (b, h) (dq: two
// products to rebuild p and dp, one for dq; dkv: two plus two) for
// ~6*L*D elements moved, so at BERT-base (L = 512, D = 64) both are bound by
// operations on the tensor cores: bf16, or split TF32 for float32, whose
// three TF32 products a float32 product leave at most 165 TFLOP/s of
// float32 work (chip_smoke.py `SPLIT_TF32_FLOPS`). Both bf16 bodies are
// built as the forward (flash_fwd.cu): persistent, one TMA producer thread
// feeding a ring of stages on mbarriers, three (D <= 64) or two (D <= 128)
// consumer warpgroups issuing wgmma, the two score-shaped products back to
// back from shared memory so the tensor cores get both at once, the keep
// bits made in registers while products run, p = exp2 of one FMA less
// lse * log2 e, and the gradient products with their A operand in
// registers:
//  * bfloat16 dq: `dq_wgmma_kernel`. A work item is 64 query rows per
//    warpgroup (Q and dO double-buffered per item); the ring carries
//    64-key K/V tiles. S = Q.K^T and dP = dO.V^T, then dq += ds.K.
//  * bfloat16 dkv: `dkv_wgmma_kernel`, the transpose. A work item is 64
//    keys per warpgroup, whose K and V stay in shared memory (double-
//    buffered per item) and whose dk, dv and key bias stay in registers;
//    the ring carries 64-query tiles of Q and dO with their lse and delta.
//    S^T = K.Q^T and dP^T = V.dO^T, then dv += p~^T.dO and dk += ds^T.Q
//    (`keep_quad_t` makes the transposed keep bits, one Philox call a lane
//    per 8-query block, as dq). dk, dv, S^T and dP^T fill 128 of the 160
//    registers a consumer has at three warpgroups, which leaves too few
//    for Philox beside S^T and dP^T (ptxas spilled): the bits of the next
//    tile are made while dv and dk run instead, and the first product of
//    S^T and of dP^T writes its accumulator without reading it, so the
//    last tile's scores hold no registers then.
//    ptxas (-Xptxas -v, sm_90a): dq and dkv take 128 registers at entry
//    at D <= 64 and 168 at D <= 128, 0 bytes spilled; setmaxnreg then
//    gives the consumers 160 (three warpgroups) or 240 (two) and the
//    producer 24.
//  * float32: `dq_split_tf32_kernel` and `dkv_split_tf32_kernel`, every
//    product on the tensor cores in split TF32 (flash_common.cuh): each
//    operand is big = tf32(x) plus small = tf32(x - big), and a product is
//    three m16n8k8 mma.sync (HMMA.1688.F32.TF32), small terms first, which
//    holds float32's accuracy where TF32 alone (10 mantissa bits) misses
//    the 1e-4 gate (7.6e-4 on dq in tests/test_torch_flash_split_tf32.py's
//    emulation at SQuAD's L = 384). The tensor cores round each
//    accumulation toward zero, so a product sums two k-steps (six mma)
//    into a fresh partial and adds it to its accumulator in float32: one
//    chain per product drifted to 1.6e-4 on a dq of |80| summed over 257
//    keys. Two output tiles' chains run interleaved, so an mma waits on
//    the one two back. A block owns ROWS rows (8 warps x 16 at D <= 64,
//    4 x 16 at D <= 128): query rows in dq, keys in dkv, raw in shared
//    memory, their A fragments split as they load. It walks the other
//    side (K/V in dq, Q/dO with lse and delta in dkv) in tiles of TR = 64
//    rows (32 at D <= 128), two stages:
//    cp.async puts tile i + 1 in flight while tile i's products run; each
//    thread splits in place the 16-byte chunks it copied (big parts beside
//    them), then one barrier a tile. Tiles are unpadded rows with an XOR
//    swizzle of 8-float groups, conflict-free for the 8-byte fragment
//    loads of S = Q.K^T and dP = dO.V^T (dkv: S^T = K.Q^T, dP^T = V.dO^T),
//    whose head-dim slots are permuted in pairs, and for the 4-byte loads
//    of dq += ds.K (dkv: dv += p~^T.dO, dk += ds^T.Q), whose contraction
//    runs over the tile's rows in the order of a score accumulator's
//    columns, so ds and p~ are A fragments where they stand, with no
//    shuffle and no trip through shared memory. The keep bits are made in
//    registers as the bf16 bodies make them (`keep_quad`, `keep_quad_t`).
//    What bounds it now: at SQuAD's (32,12,384,64) with a padding mask
//    dq and dkv take 0.505 and 0.659 ms on an H100 (chip_smoke.py), 20%
//    of the split-TF32 bound and 48-49% of the CUDA cores' float32
//    bound. The tensor cores wait on the rest of each tile's instruction
//    stream: a product of a 16-row warp tile by 8 columns and 8 k reads
//    its B fragment (big and small) for three mma, each A value is split
//    by four integer and float operations (ptxas drops the small part's
//    mask: HMMA reads a TF32 operand's top 19 bits), the keep bits cost
//    a Philox call per lane and 8 columns, and the partials' adds one
//    FADD per three mma; with 213-254 registers a thread, one block of 8
//    warps (4 at D <= 128) holds an SM, too few to hide a six-mma chain.
#include "dropout.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

// ---- float32: split TF32 on mma.sync (flash_common.cuh) -------------------

// dq and dkv own two tensors (Q and dO; K and V) and walk two (K and V
// with the key bias; Q and dO with lse and delta): F32Plan's tiling
template <int DMAX> using BwdPlan = F32Plan<DMAX, 2, 2>;

template <int DMAX>
__global__ void __launch_bounds__(BwdPlan<DMAX>::THREADS, 1)
dq_split_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int H, int Lq, int Lk, int D, float sm_scale, int causal,
                     DropoutArgs drop) {
  using P = BwdPlan<DMAX>;
  constexpr int T = P::TILE;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // own rows: Q, then dO, raw
  float* Gs = Qs + P::FIXED;
  float* walk = Gs + P::FIXED;           // stages: K, V split; key bias

  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * P::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp, r0 = q0 + wr + g, r1 = r0 + 8;
  const int off = Lk - Lq;
  const float* kh = k + (size_t)bh * Lk * D;
  const float* vh = v + (size_t)bh * Lk * D;
  const float* brow = bias + (size_t)b * Lk;
  const int nq = min(P::ROWS, Lq - q0);
  copy_tile_async<DMAX, P::THREADS, P::ROWS>(
      Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
  copy_tile_async<DMAX, P::THREADS, P::ROWS>(
      Gs, dout + ((size_t)bh * Lq + q0) * D, nq, D);
  auto load = [&](int i) {
    float* st = walk + (i & 1) * P::STAGE;
    const int k0 = i * P::TR, nk = min(P::TR, Lk - k0);
    copy_tile_async<DMAX, P::THREADS, P::TR>(st + T, kh + (size_t)k0 * D,
                                             nk, D);
    copy_tile_async<DMAX, P::THREADS, P::TR>(st + 3 * T,
                                             vh + (size_t)k0 * D, nk, D);
    if ((int)threadIdx.x < P::TR)
      cp_async4(st + 4 * T + threadIdx.x,
                brow + min(k0 + (int)threadIdx.x, Lk - 1),
                k0 + (int)threadIdx.x < Lk ? 4 : 0);
    cp_async_commit();
  };
  // the keys the block's rows see (causal: up to the last row's diagonal)
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + P::ROWS, Lq) + off);
  const int ntiles = (hi + P::TR - 1) / P::TR;
  load(0);
  int hi_w = 0;                          // the same for this warp's rows
  if (q0 + wr < Lq) {
    hi_w = Lk;
    if (causal && off >= 0) hi_w = min(Lk, min(q0 + wr + 16, Lq) + off);
  }
  // lse in the exp2 domain, rounded once: a fully masked row (lse =
  // -1e30) gets exp2(kNeg2 - kNeg2) = 1, as the plain version's exp(0)
  const float ls0 =
      __fmul_rn(r0 < Lq ? lse[(size_t)bh * Lq + r0] : 0.f, kLog2e);
  const float ls1 =
      __fmul_rn(r1 < Lq ? lse[(size_t)bh * Lq + r1] : 0.f, kLog2e);
  const float dl0 = r0 < Lq ? delta[(size_t)bh * Lq + r0] : 0.f;
  const float dl1 = r1 < Lq ? delta[(size_t)bh * Lq + r1] : 0.f;
  const float scale2 = sm_scale * kLog2e;
  const FragOffsets<DMAX> fo(g, t);
  float acc[P::ND][4];
#pragma unroll
  for (int i = 0; i < P::ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    float* st = walk + (i & 1) * P::STAGE;
    cp_async_wait<0>();
    split_tile<DMAX, P::THREADS, P::TR>(st, st + T);
    split_tile<DMAX, P::THREADS, P::TR>(st + 2 * T, st + 3 * T);
    __syncthreads();                     // tile i is whole; tile i - 1 done
    if (i + 1 < ntiles) load(i + 1);
    const int k0 = i * P::TR;
    if (k0 >= hi_w) continue;

    float sc[P::NT][4], dp[P::NT][4];    // S = Q.K^T, dP = dO.V^T
    score_tile<DMAX, P::NT>(sc, Qs + wr * DMAX, st, st + T, D, fo);
    score_tile<DMAX, P::NT>(dp, Gs + wr * DMAX, st + 2 * T, st + 3 * T, D,
                            fo);
    uint32_t keep = 0u;
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
        keep |= keep_quad(drop, bh, r0, r1, k0 + 8 * j + 2 * t, t) << (4 * j);
    }
    // sc[j][e]: row e < 2 ? r0 : r1, key k0 + 8j + 2t + (e & 1); ds in place
    const float* bsm = st + 4 * T;
#pragma unroll
    for (int j = 0; j < P::NT; ++j) {
      const int cl = 8 * j + 2 * t;
      const float b0 = __fmul_rn(bsm[cl], kLog2e);
      const float b1 = __fmul_rn(bsm[cl + 1], kLog2e);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + cl + (e & 1);
        float x = fmaf(sc[j][e], scale2, (e & 1) ? b1 : b0);
        if (causal && c > (e < 2 ? r0 : r1) + off) x = kNeg2;
        if (c >= Lk) x = -INFINITY;      // past the keys: p = 0
        const float p = ex2(x - (e < 2 ? ls0 : ls1));
        float d = dp[j][e];
        if (drop.on) d = (keep >> (4 * j + e)) & 1u ? d * drop.inv_keep : 0.f;
        sc[j][e] = p * (d - (e < 2 ? dl0 : dl1)) * sm_scale;
      }
    }
    grad_tile<DMAX, P::NT>(acc, sc, st, st + T, D, fo);   // dq += ds.K
  }
#pragma unroll
  for (int i = 0; i < P::ND; ++i) {
    const int d = 8 * i + 2 * t;
    if (d >= D) break;
    if (r0 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)bh * Lq + r0) * D + d) =
          make_float2(acc[i][0], acc[i][1]);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(dq + ((size_t)bh * Lq + r1) * D + d) =
          make_float2(acc[i][2], acc[i][3]);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(BwdPlan<DMAX>::THREADS, 1)
dkv_split_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int Lq, int Lk, int D, float sm_scale, int causal,
                      DropoutArgs drop) {
  using P = BwdPlan<DMAX>;
  constexpr int T = P::TILE;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // own keys: K, then V, raw
  float* Vs = Ks + P::FIXED;
  float* walk = Vs + P::FIXED;           // stages: Q, dO split; lse, delta

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * P::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp, c0 = k0 + wr + g, c1 = c0 + 8;
  const int off = Lk - Lq;
  const float* qh = q + (size_t)bh * Lq * D;
  const float* gh = dout + (size_t)bh * Lq * D;
  const int nk = min(P::ROWS, Lk - k0);
  copy_tile_async<DMAX, P::THREADS, P::ROWS>(
      Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
  copy_tile_async<DMAX, P::THREADS, P::ROWS>(
      Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
  auto load = [&](int i) {
    float* st = walk + (i & 1) * P::STAGE;
    const int q0 = i * P::TR, nq = min(P::TR, Lq - q0);
    copy_tile_async<DMAX, P::THREADS, P::TR>(st + T, qh + (size_t)q0 * D,
                                             nq, D);
    copy_tile_async<DMAX, P::THREADS, P::TR>(st + 3 * T,
                                             gh + (size_t)q0 * D, nq, D);
    if ((int)threadIdx.x < 2 * P::TR) {       // lse, then delta, of the tile
      const int r = threadIdx.x % P::TR;
      const float* src = (int)threadIdx.x < P::TR ? lse : delta;
      cp_async4(st + 4 * T + threadIdx.x,
                src + (size_t)bh * Lq + min(q0 + r, Lq - 1),
                q0 + r < Lq ? 4 : 0);
    }
    cp_async_commit();
  };
  // the first q tile that sees the block's keys (causal)
  int lo = 0;
  if (causal && off >= 0) lo = max(0, k0 - off) / P::TR;
  const int ntiles = (Lq + P::TR - 1) / P::TR;
  load(lo);
  int lo_w = ntiles;                     // the same for this warp's keys
  if (k0 + wr < Lk) {
    lo_w = 0;
    if (causal && off >= 0) lo_w = max(0, k0 + wr - off) / P::TR;
  }
  // the key bias in the exp2 domain; keys past Lk get p = 0 below
  const float b0 = c0 < Lk ? __fmul_rn(bias[(size_t)b * Lk + c0], kLog2e) : 0.f;
  const float b1 = c1 < Lk ? __fmul_rn(bias[(size_t)b * Lk + c1], kLog2e) : 0.f;
  const float scale2 = sm_scale * kLog2e;
  const FragOffsets<DMAX> fo(g, t);
  float dka[P::ND][4], dva[P::ND][4];
#pragma unroll
  for (int i = 0; i < P::ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int i = lo; i < ntiles; ++i) {
    float* st = walk + (i & 1) * P::STAGE;
    cp_async_wait<0>();
    split_tile<DMAX, P::THREADS, P::TR>(st, st + T);
    split_tile<DMAX, P::THREADS, P::TR>(st + 2 * T, st + 3 * T);
    __syncthreads();                     // tile i is whole; tile i - 1 done
    if (i + 1 < ntiles) load(i + 1);
    if (i < lo_w) continue;
    const int q0 = i * P::TR;

    float sc[P::NT][4], dp[P::NT][4];    // S^T = K.Q^T, dP^T = V.dO^T
    score_tile<DMAX, P::NT>(sc, Ks + wr * DMAX, st, st + T, D, fo);
    score_tile<DMAX, P::NT>(dp, Vs + wr * DMAX, st + 2 * T, st + 3 * T, D,
                            fo);
    uint32_t keep = 0u;
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
        keep |= keep_quad_t(drop, bh, q0 + 8 * j + 2 * t, c0 >> 2, g & 3)
                << (4 * j);
    }
    // sc[j][e]: key e < 2 ? c0 : c1, query q0 + 8j + 2t + (e & 1);
    // p~^T in sc, ds^T in dp
    const float* lsm = st + 4 * T;
    const float* dsm = lsm + P::TR;
#pragma unroll
    for (int j = 0; j < P::NT; ++j) {
      const int ql = 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + ql + (e & 1), key = e < 2 ? c0 : c1;
        // queries past Lq: p = 0
        const float ls =
            qi < Lq ? __fmul_rn(lsm[ql + (e & 1)], kLog2e) : INFINITY;
        float x = fmaf(sc[j][e], scale2, e < 2 ? b0 : b1);
        if (causal && key > qi + off) x = kNeg2;
        if (key >= Lk) x = -INFINITY;
        const float p = ex2(x - ls);
        float d = dp[j][e], pv = p;
        if (drop.on) {
          const bool kept = (keep >> (4 * j + e)) & 1u;
          pv = kept ? p * drop.inv_keep : 0.f;
          d = kept ? d * drop.inv_keep : 0.f;
        }
        sc[j][e] = pv;
        dp[j][e] = p * (d - dsm[ql + (e & 1)]) * sm_scale;
      }
    }
    grad_tile<DMAX, P::NT>(dva, sc, st + 2 * T, st + 3 * T, D, fo);  // p~^T.dO
    grad_tile<DMAX, P::NT>(dka, dp, st, st + T, D, fo);              // ds^T.Q
  }
#pragma unroll
  for (int i = 0; i < P::ND; ++i) {
    const int d = 8 * i + 2 * t;
    if (d >= D) break;
    if (c0 < Lk) {
      const size_t o = ((size_t)bh * Lk + c0) * D + d;
      *reinterpret_cast<float2*>(dk + o) = make_float2(dka[i][0], dka[i][1]);
      *reinterpret_cast<float2*>(dv + o) = make_float2(dva[i][0], dva[i][1]);
    }
    if (c1 < Lk) {
      const size_t o = ((size_t)bh * Lk + c1) * D + d;
      *reinterpret_cast<float2*>(dk + o) = make_float2(dka[i][2], dka[i][3]);
      *reinterpret_cast<float2*>(dv + o) = make_float2(dva[i][2], dva[i][3]);
    }
  }
}

// ---- bfloat16 dq: TMA-fed wgmma, warp-specialised, persistent ---------------

constexpr int DQ_KEYS = 64;      // keys of a K/V tile

// shared memory, every tile on a 1024-byte boundary: two buffers of an
// item's Q and dO (the item in work and the next) as [buffer][Q, dO]
// [warpgroup][64-column chunk][64 rows], a ring of K and V tiles as
// [stage][chunk][64 keys], the bias of each stage's keys, the barriers
template <int DMAX> struct DqPlan {
  static constexpr int NCH = DMAX / 64;
  // consumer warpgroups and their registers, as the forward's: three with
  // 160 at D <= 64, two with 240 at D <= 128; the producer keeps 24
  static constexpr int NWG = DMAX == 64 ? 3 : 2;
  static constexpr int REGS = DMAX == 64 ? 160 : 240;
  static constexpr int ROWS = 64 * NWG;               // rows of a work item
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int STAGES = DMAX == 64 ? 4 : 2;
  static constexpr int TILE = 64 * 128;               // 64 rows x 128 bytes
  static constexpr int KV_BYTES = NCH * TILE;         // one K (or V) tile
  // a stage's bias: DQ_KEYS + 4 values from the 16-byte boundary at or
  // below the tile's first key (a TMA box starts on a 16-byte boundary)
  static constexpr int BIAS_BOX = DQ_KEYS + 4;
  static constexpr int BIAS_BYTES = 384;              // a 128-byte multiple
  static constexpr int G_OFF = NWG * NCH * TILE;      // dO after Q
  static constexpr int Q_BUF = 2 * G_OFF;             // one item's Q and dO
  static constexpr int K_OFF = 2 * Q_BUF;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int B_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = B_OFF + STAGES * BIAS_BYTES;
  static constexpr int bytes = BAR_OFF + (4 + 2 * STAGES) * 8 + 1024;
};

// A work item is one (b*h, ROWS-row q tile), ordered as the forward's.
template <int ROWS> struct DqItem {
  int bh, q0, ntiles;
  __device__ DqItem(int i, int BH, int nq, int Lq, int Lk, int causal) {
    int qt;
    if (causal) {
      qt = nq - 1 - i / BH;
      bh = i % BH;
    } else {
      bh = i / nq;
      qt = i % nq;
    }
    q0 = qt * ROWS;
    int hi = Lk;                           // as the forward
    if (causal && Lk >= Lq) hi = min(Lk, min(q0 + ROWS, Lq) + Lk - Lq);
    ntiles = (hi + DQ_KEYS - 1) / DQ_KEYS;
  }
};

// Persistent, as the forward: the producer warpgroup's first thread loads
// an item's Q and dO into the free buffer, then K, V and the bias of each
// 64-key tile into a ring of stages, running ahead across items. Each
// consumer warpgroup owns 64 query rows of an item: S = Q.K^T and dP =
// dO.V^T by two back-to-back wgmma batches from shared memory (the keep
// bits are computed while they run), p = exp2(x - lse log2 e) and ds = p
// (dp - delta) sm_scale in registers, ds rounded to bf16 as the A operand
// of dq += ds.K (K key-major: the transpose bit). dq leaves through the
// warpgroup's Q tiles and a TMA store.
template <int DMAX>
__global__ void __launch_bounds__(DqPlan<DMAX>::THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tdq,
                const float* __restrict__ lse, const float* __restrict__ delta,
                int BH, int H, int Lq, int Lk, float sm_scale, int causal,
                DropoutArgs drop) {
  using P = DqPlan<DMAX>;
  constexpr int NCH = P::NCH, S = P::STAGES, NWG = P::NWG;
  using Item = DqItem<P::ROWS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + S;
  const int nq = (Lq + P::ROWS - 1) / P::ROWS;
  const int items = BH * nq;
  const int off = Lk - Lq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], NWG);          // one thread of each warpgroup
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);       // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == NWG) {                         // ---- producer
    regs_dealloc<24>();
    if (tid == 128 * NWG) {
      int g = 0;
      for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
        const Item w(i, BH, nq, Lq, Lk, causal);
        const int qb = it & 1, b = w.bh / H;
        uint8_t* qs = base + qb * P::Q_BUF;
        mbar_wait(&qempty[qb], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], P::Q_BUF);
        for (int r = 0; r < NWG; ++r)
          for (int c = 0; c < NCH; ++c) {
            tma_load_3d(qs + (r * NCH + c) * P::TILE, &tq, &qfull[qb],
                        64 * c, w.q0 + 64 * r, w.bh);
            tma_load_3d(qs + P::G_OFF + (r * NCH + c) * P::TILE, &tg,
                        &qfull[qb], 64 * c, w.q0 + 64 * r, w.bh);
          }
        for (int t = 0; t < w.ntiles; ++t, ++g) {
          const int s = g % S;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * P::KV_BYTES + 4 * P::BIAS_BOX);
          for (int c = 0; c < NCH; ++c) {
            tma_load_3d(base + P::K_OFF + s * P::KV_BYTES + c * P::TILE, &tk,
                        &full[s], 64 * c, t * DQ_KEYS, w.bh);
            tma_load_3d(base + P::V_OFF + s * P::KV_BYTES + c * P::TILE, &tv,
                        &full[s], 64 * c, t * DQ_KEYS, w.bh);
          }
          tma_load_1d(base + P::B_OFF + s * P::BIAS_BYTES, &tb, &full[s],
                      (b * Lk + t * DQ_KEYS) & ~3);
        }
      }
    }
    return;
  }

  // ---- consumers
  regs_alloc<P::REGS>();
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = sm_scale * kLog2e;
  float dq[NCH][32], sacc[32], dpacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
  int g = 0;
  for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
    const Item w(i, BH, nq, Lq, Lk, causal);
    const int qb = it & 1, bh = w.bh, b = bh / H;
    const int qw = w.q0 + 64 * wg;
    const int r0 = qw + 16 * warp + gid, r1 = r0 + 8;
    int my_tiles = 0;
    if (qw < Lq) {
      int hi_w = Lk;
      if (causal && off >= 0) hi_w = min(Lk, min(qw + 64, Lq) + off);
      my_tiles = (hi_w + DQ_KEYS - 1) / DQ_KEYS;
    }
    // lse in the exp2 domain, rounded once (never contracted into x -
    // lse2): a fully masked row (lse = -1e30) gets exp2(kNeg2 - kNeg2) = 1
    const float ls0 =
        __fmul_rn(r0 < Lq ? lse[(size_t)bh * Lq + r0] : 0.f, kLog2e);
    const float ls1 =
        __fmul_rn(r1 < Lq ? lse[(size_t)bh * Lq + r1] : 0.f, kLog2e);
    const float dl0 = r0 < Lq ? delta[(size_t)bh * Lq + r0] : 0.f;
    const float dl1 = r1 < Lq ? delta[(size_t)bh * Lq + r1] : 0.f;
    uint8_t* qs = base + qb * P::Q_BUF + wg * NCH * P::TILE;
    const uint8_t* gs = qs + P::G_OFF;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int k = 0; k < 32; ++k) dq[c][k] = 0.f;
    mbar_wait(&qfull[qb], (it >> 1) & 1);

    for (int t = 0; t < w.ntiles; ++t, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      if (t < my_tiles) {
        const int k0 = t * DQ_KEYS;
        const uint8_t* ks = base + P::K_OFF + s * P::KV_BYTES;
        const uint8_t* vs = base + P::V_OFF + s * P::KV_BYTES;
        const float* bsm = reinterpret_cast<const float*>(
                               base + P::B_OFF + s * P::BIAS_BYTES) +
                           ((b * Lk + k0) & 3);

        // S = Q.K^T and dP = dO.V^T, issued back to back
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(sacc, sw128_desc(qs + c * P::TILE + 32 * kk, 16),
                         sw128_desc(ks + c * P::TILE + 32 * kk, 16),
                         c + kk > 0);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dpacc, sw128_desc(gs + c * P::TILE + 32 * kk, 16),
                         sw128_desc(vs + c * P::TILE + 32 * kk, 16),
                         c + kk > 0);
        wg_commit();
        uint32_t keep = 0u;                 // while the tensor cores run
        if (drop.on) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            keep |= keep_quad(drop, bh, r0, r1, k0 + 8 * j + 2 * tig, tig)
                    << (4 * j);
        }
        wg_wait<0>();
        wg_hold(sacc);
        wg_hold(dpacc);

        // accumulator 4j + e: row e < 2 ? r0 : r1, key k0 + 8j + 2 tig +
        // (e & 1); ds as bf16 A fragments (keys 16kk.. = df[4kk..])
        const bool masked =
            k0 + DQ_KEYS > Lk || (causal && k0 + DQ_KEYS - 1 > qw + off);
        uint32_t df[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float b0 = __fmul_rn(bsm[col], kLog2e);
          const float b1 = __fmul_rn(bsm[col + 1], kLog2e);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(sacc[4 * j + e], scale2, (e & 1) ? b1 : b0);
            if (masked) {
              const int c = k0 + col + (e & 1);
              if (causal && c > (e < 2 ? r0 : r1) + off) x = kNeg2;
              if (c >= Lk) x = -INFINITY;  // past the keys: p = 0
            }
            const float p = ex2(x - (e < 2 ? ls0 : ls1));
            float dp = dpacc[4 * j + e];
            if (drop.on)
              dp = (keep >> (4 * j + e)) & 1u ? dp * drop.inv_keep : 0.f;
            ds[e] = p * (dp - (e < 2 ? dl0 : dl1)) * sm_scale;
          }
          df[2 * j] = pack_bf16(ds[0], ds[1]);
          df[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dq += ds.K
#pragma unroll
        for (int c = 0; c < NCH; ++c) wg_hold(dq[c]);
        wg_hold(df);
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t a[4] = {df[4 * kk], df[4 * kk + 1], df[4 * kk + 2],
                                   df[4 * kk + 3]};
            wgmma_rs_n64_t(dq[c], a,
                           sw128_desc(ks + c * P::TILE + kk * 2048, P::TILE),
                           1);
          }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NCH; ++c) wg_hold(dq[c]);
        wg_hold(df);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage goes back
    }

    // ---- epilogue: dq as bf16 through this warpgroup's Q tiles
    if (my_tiles > 0) {
      named_sync(1 + wg, 128);
      __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(qs);
      const int rl0 = 16 * warp + gid, rl1 = rl0 + 8;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(os + c * 64 * 64 + sw128(rl0, col)) =
              pack_bf16(dq[c][4 * j], dq[c][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(os + c * 64 * 64 + sw128(rl1, col)) =
              pack_bf16(dq[c][4 * j + 2], dq[c][4 * j + 3]);
        }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (wt == 0) {                       // rows past Lq are not written
        for (int c = 0; c < NCH; ++c)
          tma_store_3d(&tdq, os + c * 64 * 64, 64 * c, qw, bh);
        tma_store_drain();
      }
    }
    if (wt == 0) mbar_arrive(&qempty[qb]);   // the buffer goes back
  }
}

// ---- bfloat16 dk, dv: TMA-fed wgmma, warp-specialised, persistent -----------

constexpr int DKV_QROWS = 64;    // queries of a Q/dO tile

// shared memory, every tile on a 1024-byte boundary: two buffers of an
// item's K and V (the item in work and the next) as [buffer][K, V]
// [warpgroup][64-column chunk][64 keys], the bias of each buffer's keys, a
// ring of Q and dO tiles as [stage][chunk][64 queries], the lse and delta
// of each stage's queries, the barriers
template <int DMAX> struct DkvPlan {
  static constexpr int NCH = DMAX / 64;
  // consumer warpgroups and their registers, as dq's: three with 160 at
  // D <= 64, two with 240 at D <= 128; the producer keeps 24
  static constexpr int NWG = DMAX == 64 ? 3 : 2;
  static constexpr int REGS = DMAX == 64 ? 160 : 240;
  static constexpr int KEYS = 64 * NWG;               // keys of a work item
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int STAGES = DMAX == 64 ? 4 : 2;
  static constexpr int TILE = 64 * 128;               // 64 rows x 128 bytes
  static constexpr int Q_BYTES = NCH * TILE;          // one Q (or dO) tile
  static constexpr int V_OFF = NWG * NCH * TILE;      // V after K
  static constexpr int KV_BUF = 2 * V_OFF;            // one item's K and V
  // an item's bias, and a stage's lse (and delta): the values from the
  // 16-byte boundary at or below the first key (query), plus 4 (a TMA box
  // starts on a 16-byte boundary)
  static constexpr int BIAS_BOX = KEYS + 4;
  static constexpr int BIAS_BYTES = 1024;
  static constexpr int ROW_BOX = DKV_QROWS + 4;
  static constexpr int ROW_BYTES = 384;               // a 128-byte multiple
  static constexpr int B_OFF = 2 * KV_BUF;
  static constexpr int Q_OFF = B_OFF + 2 * BIAS_BYTES;
  static constexpr int G_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int L_OFF = G_OFF + STAGES * Q_BYTES;
  static constexpr int E_OFF = L_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = E_OFF + STAGES * ROW_BYTES;
  static constexpr int bytes = BAR_OFF + (4 + 2 * STAGES) * 8 + 1024;
};

// A work item is one (b*h, KEYS-key tile); `lo` is the first q tile that
// can see its first key. Causal items run longest (lowest keys) first, the
// others a head's key tiles next to each other.
template <int KEYS> struct DkvItem {
  int bh, k0, lo;
  __device__ DkvItem(int i, int BH, int nk, int Lq, int Lk, int causal) {
    int kt;
    if (causal) {
      kt = i / BH;
      bh = i % BH;
    } else {
      bh = i / nk;
      kt = i % nk;
    }
    k0 = kt * KEYS;
    lo = 0;
    if (causal && Lk >= Lq) lo = max(0, k0 - (Lk - Lq)) / DKV_QROWS;
  }
};

// The transpose of dq's design: the producer warpgroup's first thread
// loads an item's K, V and key bias into the free buffer, then streams the
// item's 64-query tiles of Q and dO, with their lse and delta, into a ring
// of stages, running ahead across items. Each consumer warpgroup owns 64
// keys, whose K and V stay in shared memory and whose dk, dv and bias stay
// in registers: S^T = K.Q^T and dP^T = V.dO^T by two back-to-back wgmma
// batches from shared memory (the keep bits are made while they run), p =
// exp2(x - lse log2 e), p~ (p dropped and scaled) and ds = p (dp - delta)
// sm_scale in registers, each rounded to bf16 as the A operand of dv +=
// p~^T.dO and dk += ds^T.Q (dO and Q query-major: the transpose bit). dk
// and dv leave through the warpgroup's K and V tiles and TMA stores.
template <int DMAX>
__global__ void __launch_bounds__(DkvPlan<DMAX>::THREADS, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tl,
                 const __grid_constant__ CUtensorMap te,
                 const __grid_constant__ CUtensorMap tdk,
                 const __grid_constant__ CUtensorMap tdv, int BH, int H,
                 int Lq, int Lk, float sm_scale, int causal,
                 DropoutArgs drop) {
  using P = DkvPlan<DMAX>;
  constexpr int NCH = P::NCH, S = P::STAGES, NWG = P::NWG;
  using Item = DkvItem<P::KEYS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* kvempty = kvfull + 2;
  uint64_t* full = kvempty + 2;
  uint64_t* empty = full + S;
  const int nk = (Lk + P::KEYS - 1) / P::KEYS;
  const int nqt = (Lq + DKV_QROWS - 1) / DKV_QROWS;
  const int items = BH * nk;
  const int off = Lk - Lq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kvfull[i], 1);
      mbar_init(&kvempty[i], NWG);         // one thread of each warpgroup
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);       // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == NWG) {                         // ---- producer
    regs_dealloc<24>();
    if (tid == 128 * NWG) {
      int g = 0;
      for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
        const Item w(i, BH, nk, Lq, Lk, causal);
        const int kb = it & 1, b = w.bh / H;
        uint8_t* kv = base + kb * P::KV_BUF;
        mbar_wait(&kvempty[kb], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&kvfull[kb], P::KV_BUF + 4 * P::BIAS_BOX);
        for (int r = 0; r < NWG; ++r)
          for (int c = 0; c < NCH; ++c) {
            tma_load_3d(kv + (r * NCH + c) * P::TILE, &tk, &kvfull[kb],
                        64 * c, w.k0 + 64 * r, w.bh);
            tma_load_3d(kv + P::V_OFF + (r * NCH + c) * P::TILE, &tv,
                        &kvfull[kb], 64 * c, w.k0 + 64 * r, w.bh);
          }
        tma_load_1d(base + P::B_OFF + kb * P::BIAS_BYTES, &tb, &kvfull[kb],
                    (b * Lk + w.k0) & ~3);
        for (int t = w.lo; t < nqt; ++t, ++g) {
          const int s = g % S, q0 = t * DKV_QROWS;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * P::Q_BYTES + 8 * P::ROW_BOX);
          for (int c = 0; c < NCH; ++c) {
            tma_load_3d(base + P::Q_OFF + s * P::Q_BYTES + c * P::TILE, &tq,
                        &full[s], 64 * c, q0, w.bh);
            tma_load_3d(base + P::G_OFF + s * P::Q_BYTES + c * P::TILE, &tg,
                        &full[s], 64 * c, q0, w.bh);
          }
          const int r0 = (w.bh * Lq + q0) & ~3;
          tma_load_1d(base + P::L_OFF + s * P::ROW_BYTES, &tl, &full[s], r0);
          tma_load_1d(base + P::E_OFF + s * P::ROW_BYTES, &te, &full[s], r0);
        }
      }
    }
    return;
  }

  // ---- consumers
  regs_alloc<P::REGS>();
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = sm_scale * kLog2e;
  float dk[NCH][32], dv[NCH][32], sacc[32], dpacc[32];
  int g = 0;
  uint32_t keep = 0u;                      // keep bits of the next q tile
  for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
    const Item w(i, BH, nk, Lq, Lk, causal);
    const int kb = it & 1, bh = w.bh, b = bh / H;
    const int kw = w.k0 + 64 * wg;         // this warpgroup's first key
    const int c0 = kw + 16 * warp + gid, c1 = c0 + 8;   // this thread's keys
    int my_lo = nqt;                       // keys past Lk: no q tile
    if (kw < Lk) {
      my_lo = w.lo;
      if (causal && off >= 0) my_lo = max(0, kw - off) / DKV_QROWS;
    }
    uint8_t* ks = base + kb * P::KV_BUF + wg * NCH * P::TILE;
    uint8_t* vs = ks + P::V_OFF;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int k = 0; k < 32; ++k) dk[c][k] = dv[c][k] = 0.f;
    mbar_wait(&kvfull[kb], (it >> 1) & 1);
    // the bias of this thread's keys in the exp2 domain; keys past Lk
    // carry zero weight (their rows are not stored)
    const float* bsm =
        reinterpret_cast<const float*>(base + P::B_OFF + kb * P::BIAS_BYTES) +
        ((b * Lk + w.k0) & 3);
    const float bk0 =
        c0 < Lk ? __fmul_rn(bsm[c0 - w.k0], kLog2e) : -INFINITY;
    const float bk1 =
        c1 < Lk ? __fmul_rn(bsm[c1 - w.k0], kLog2e) : -INFINITY;

    for (int t = w.lo; t < nqt; ++t, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      if (t >= my_lo) {
        const int q0 = t * DKV_QROWS;
        const uint8_t* qs = base + P::Q_OFF + s * P::Q_BYTES;
        const uint8_t* gs = base + P::G_OFF + s * P::Q_BYTES;
        const int ro = (bh * Lq + q0) & 3;
        const float* lsm =
            reinterpret_cast<const float*>(base + P::L_OFF + s * P::ROW_BYTES) +
            ro;
        const float* esm =
            reinterpret_cast<const float*>(base + P::E_OFF + s * P::ROW_BYTES) +
            ro;

        if (drop.on && t == my_lo)          // the item's first tile
          keep = keep_tile_t(drop, bh, q0 + 2 * tig, c0 >> 2, gid & 3);

        // S^T = K.Q^T and dP^T = V.dO^T, issued back to back; the first
        // product of each writes its accumulator without reading it, so
        // the last tile's values need no registers while dv and dk run
        wg_fence();
        wgmma_ss_n64_first(sacc, sw128_desc(ks, 16), sw128_desc(qs, 16));
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = c == 0; kk < 4; ++kk)
            wgmma_ss_n64(sacc, sw128_desc(ks + c * P::TILE + 32 * kk, 16),
                         sw128_desc(qs + c * P::TILE + 32 * kk, 16), 1);
        wgmma_ss_n64_first(dpacc, sw128_desc(vs, 16), sw128_desc(gs, 16));
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = c == 0; kk < 4; ++kk)
            wgmma_ss_n64(dpacc, sw128_desc(vs + c * P::TILE + 32 * kk, 16),
                         sw128_desc(gs + c * P::TILE + 32 * kk, 16), 1);
        wg_commit();
        wg_wait<0>();
        wg_hold(sacc);
        wg_hold(dpacc);

        // accumulator 4j + e: key e < 2 ? c0 : c1, query q0 + 8j + 2 tig +
        // (e & 1); p~ and ds as bf16 A fragments (queries 16kk.. =
        // pf[4kk..], df[4kk..])
        const bool masked =
            q0 + DKV_QROWS > Lq || (causal && kw + 63 > q0 + off);
        uint32_t pf[16], df[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          // lse in the exp2 domain, rounded once (never contracted into
          // x - lse2): a fully masked row (lse = -1e30) gets
          // exp2(kNeg2 - kNeg2) = 1, as in dq
          const float ls0 = __fmul_rn(lsm[col], kLog2e);
          const float ls1 = __fmul_rn(lsm[col + 1], kLog2e);
          const float dl0 = esm[col], dl1 = esm[col + 1];
          float pd[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(sacc[4 * j + e], scale2, e < 2 ? bk0 : bk1);
            bool past = false;
            if (masked) {
              const int qq = q0 + col + (e & 1);
              if (causal && (e < 2 ? c0 : c1) > qq + off) x = kNeg2;
              past = qq >= Lq;              // past the queries: no weight
            }
            const float p = past ? 0.f : ex2(x - ((e & 1) ? ls1 : ls0));
            float dp = dpacc[4 * j + e], pk = p;
            if (drop.on) {
              const bool kept = (keep >> (4 * j + e)) & 1u;
              pk = kept ? p * drop.inv_keep : 0.f;
              dp = kept ? dp * drop.inv_keep : 0.f;
            }
            pd[e] = pk;
            ds[e] = past ? 0.f : p * (dp - ((e & 1) ? dl1 : dl0)) * sm_scale;
          }
          pf[2 * j] = pack_bf16(pd[0], pd[1]);
          pf[2 * j + 1] = pack_bf16(pd[2], pd[3]);
          df[2 * j] = pack_bf16(ds[0], ds[1]);
          df[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dv += p~^T.dO and dk += ds^T.Q
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          wg_hold(dv[c]);
          wg_hold(dk[c]);
        }
        wg_hold(pf);
        wg_hold(df);
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                                   pf[4 * kk + 3]};
            wgmma_rs_n64_t(dv[c], a,
                           sw128_desc(gs + c * P::TILE + kk * 2048, P::TILE),
                           1);
          }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t a[4] = {df[4 * kk], df[4 * kk + 1], df[4 * kk + 2],
                                   df[4 * kk + 3]};
            wgmma_rs_n64_t(dk[c], a,
                           sw128_desc(qs + c * P::TILE + kk * 2048, P::TILE),
                           1);
          }
        wg_commit();
        // the next tile's keep bits while the tensor cores run (there, not
        // beside S^T and dP^T, whose accumulators leave no registers for
        // Philox at three warpgroups)
        if (drop.on && t + 1 < nqt)
          keep = keep_tile_t(drop, bh, q0 + DKV_QROWS + 2 * tig, c0 >> 2,
                             gid & 3);
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          wg_hold(dv[c]);
          wg_hold(dk[c]);
        }
        wg_hold(pf);
        wg_hold(df);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage goes back
    }

    // ---- epilogue: dk and dv as bf16 through this warpgroup's K, V tiles
    if (kw < Lk) {
      named_sync(1 + wg, 128);
      __nv_bfloat16* ko = reinterpret_cast<__nv_bfloat16*>(ks);
      __nv_bfloat16* vo = reinterpret_cast<__nv_bfloat16*>(vs);
      const int rl0 = 16 * warp + gid, rl1 = rl0 + 8;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(ko + c * 64 * 64 + sw128(rl0, col)) =
              pack_bf16(dk[c][4 * j], dk[c][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(ko + c * 64 * 64 + sw128(rl1, col)) =
              pack_bf16(dk[c][4 * j + 2], dk[c][4 * j + 3]);
          *reinterpret_cast<uint32_t*>(vo + c * 64 * 64 + sw128(rl0, col)) =
              pack_bf16(dv[c][4 * j], dv[c][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(vo + c * 64 * 64 + sw128(rl1, col)) =
              pack_bf16(dv[c][4 * j + 2], dv[c][4 * j + 3]);
        }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (wt == 0) {                       // rows past Lk are not written
        for (int c = 0; c < NCH; ++c) {
          tma_store_3d(&tdk, ko + c * 64 * 64, 64 * c, kw, bh);
          tma_store_3d(&tdv, vo + c * 64 * 64, 64 * c, kw, bh);
        }
        tma_store_drain();
      }
    }
    if (wt == 0) mbar_arrive(&kvempty[kb]);   // the buffer goes back
  }
}

struct BwdArgs {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  int B, H, Lq, Lk, D;
  float sm_scale;
  int causal;
  DropoutArgs drop;
  cudaStream_t stream;
};

template <int DMAX>
cudaError_t launch_dq(const BwdArgs& a, int dtype, void* dq) {
  cudaError_t e;
  if (dtype == kF32) {
    using P = BwdPlan<DMAX>;
    const dim3 grid(a.B * a.H, (a.Lq + P::ROWS - 1) / P::ROWS);
    static bool configured = false;
    if ((e = allow_smem(dq_split_tf32_kernel<DMAX>, P::bytes, configured)))
      return e;
    dq_split_tf32_kernel<DMAX><<<grid, P::THREADS, P::bytes, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.bias, (const float*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (float*)dq, a.H, a.Lq, a.Lk, a.D, a.sm_scale,
        a.causal, a.drop);
  } else {
    const int BH = a.B * a.H;
    CUtensorMap tq, tk, tv, tb, tg, tdq;
    if (!map_rows_bf16(&tq, a.q, BH, a.Lq, a.D, 64) ||
        !map_rows_bf16(&tk, a.k, BH, a.Lk, a.D, DQ_KEYS) ||
        !map_rows_bf16(&tv, a.v, BH, a.Lk, a.D, DQ_KEYS) ||
        !map_flat_f32(&tb, a.bias, (size_t)a.B * a.Lk, DqPlan<DMAX>::BIAS_BOX) ||
        !map_rows_bf16(&tg, a.dout, BH, a.Lq, a.D, 64) ||
        !map_rows_bf16(&tdq, dq, BH, a.Lq, a.D, 64))
      return cudaErrorInvalidValue;
    static bool configured = false;
    constexpr int bytes = DqPlan<DMAX>::bytes;
    if ((e = allow_smem(dq_wgmma_kernel<DMAX>, bytes, configured))) return e;
    const int wgrid = persistent_grid(
        BH * ((a.Lq + DqPlan<DMAX>::ROWS - 1) / DqPlan<DMAX>::ROWS));
    dq_wgmma_kernel<DMAX><<<wgrid, DqPlan<DMAX>::THREADS, bytes, a.stream>>>(
        tq, tk, tv, tb, tg, tdq, (const float*)a.lse, (const float*)a.delta,
        BH, a.H, a.Lq, a.Lk, a.sm_scale, a.causal, a.drop);
  }
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const BwdArgs& a, int dtype, void* dk, void* dv) {
  cudaError_t e;
  if (dtype == kF32) {
    using P = BwdPlan<DMAX>;
    const dim3 grid(a.B * a.H, (a.Lk + P::ROWS - 1) / P::ROWS);
    static bool configured = false;
    if ((e = allow_smem(dkv_split_tf32_kernel<DMAX>, P::bytes, configured)))
      return e;
    dkv_split_tf32_kernel<DMAX><<<grid, P::THREADS, P::bytes, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.bias, (const float*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (float*)dk, (float*)dv, a.H, a.Lq, a.Lk, a.D,
        a.sm_scale, a.causal, a.drop);
  } else {
    using P = DkvPlan<DMAX>;
    const int BH = a.B * a.H;
    CUtensorMap tq, tk, tv, tb, tg, tl, te, tdk, tdv;
    if (!map_rows_bf16(&tq, a.q, BH, a.Lq, a.D, DKV_QROWS) ||
        !map_rows_bf16(&tk, a.k, BH, a.Lk, a.D, 64) ||
        !map_rows_bf16(&tv, a.v, BH, a.Lk, a.D, 64) ||
        !map_flat_f32(&tb, a.bias, (size_t)a.B * a.Lk, P::BIAS_BOX) ||
        !map_rows_bf16(&tg, a.dout, BH, a.Lq, a.D, DKV_QROWS) ||
        !map_flat_f32(&tl, a.lse, (size_t)BH * a.Lq, P::ROW_BOX) ||
        !map_flat_f32(&te, a.delta, (size_t)BH * a.Lq, P::ROW_BOX) ||
        !map_rows_bf16(&tdk, dk, BH, a.Lk, a.D, 64) ||
        !map_rows_bf16(&tdv, dv, BH, a.Lk, a.D, 64))
      return cudaErrorInvalidValue;
    static bool configured = false;
    if ((e = allow_smem(dkv_wgmma_kernel<DMAX>, P::bytes, configured)))
      return e;
    const int wgrid =
        persistent_grid(BH * ((a.Lk + P::KEYS - 1) / P::KEYS));
    dkv_wgmma_kernel<DMAX><<<wgrid, P::THREADS, P::bytes, a.stream>>>(
        tq, tk, tv, tb, tg, tl, te, tdk, tdv, BH, a.H, a.Lq, a.Lk,
        a.sm_scale, a.causal, a.drop);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lk, int D, int dtype) {
  return D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0 || B <= 0 ||
         H <= 0 || (dtype != kF32 && dtype != kBF16);
}

}  // namespace
}  // namespace mxt

// q, dout (B,H,Lq,D), k/v (B,H,Lk,D) contiguous, dtype 0 = float32,
// 1 = bfloat16; bias (B,Lk) float32; lse, delta (B*H, Lq) float32; the
// gradient outputs like their inputs. D % 8 == 0, D <= 128. Dropout as in
// mx_flash_fwd. Each returns the CUDA error of its launch (0 on success).
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int Lq, int Lk, int D,
                               float sm_scale, int causal, int dtype,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t threshold, float inv_keep,
                               int dropout_on, void* stream) {
  using namespace mxt;
  if (bad_shape(B, H, Lq, Lk, D, dtype)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, bias, dout, lse, delta, B, H, Lq, Lk, D, sm_scale,
                  causal,
                  DropoutArgs{seed_lo, seed_hi, threshold, inv_keep, dropout_on},
                  static_cast<cudaStream_t>(stream)};
  return D <= 64 ? launch_dq<64>(a, dtype, dq) : launch_dq<128>(a, dtype, dq);
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int D,
                                float sm_scale, int causal, int dtype,
                                uint32_t seed_lo, uint32_t seed_hi,
                                uint32_t threshold, float inv_keep,
                                int dropout_on, void* stream) {
  using namespace mxt;
  if (bad_shape(B, H, Lq, Lk, D, dtype)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, bias, dout, lse, delta, B, H, Lq, Lk, D, sm_scale,
                  causal,
                  DropoutArgs{seed_lo, seed_hi, threshold, inv_keep, dropout_on},
                  static_cast<cudaStream_t>(stream)};
  return D <= 64 ? launch_dkv<64>(a, dtype, dk, dv)
                 : launch_dkv<128>(a, dtype, dk, dv);
}
