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
//   dq = sum_k ds.k            (dq kernel: a block per 64-row q tile (f32),
//                               a warpgroup per 64 rows (bf16))
//   dv = sum_q p~^T.dO, dk = sum_q ds^T.q
//                              (dkv kernel: one block per 64-key tile)
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
// operations on the bf16 tensor cores. Bodies, chosen by dtype:
//  * bfloat16 dq: `dq_wgmma_kernel`, built as the forward (flash_fwd.cu):
//    persistent, one TMA producer warp feeding a ring of 64-key K/V tiles
//    (Q and dO double-buffered per work item), three (D <= 64) or two
//    (D <= 128) consumer warpgroups
//    issuing wgmma: S = Q.K^T and dP = dO.V^T back to back from shared
//    memory, so the tensor cores get both products at once, and dq += ds.K
//    with ds in registers; the keep bits are made in registers while the
//    first two run, and p = exp2 of one FMA less lse * log2 e.
//    ptxas (CUDA 12.9, -Xptxas -v): 128 registers at entry at D <= 64 and
//    168 at D <= 128, 0 bytes spilled; setmaxnreg then gives the consumers
//    160 (three warpgroups) or 240 (two) and the producer 24.
//  * bfloat16 dkv: `mma.sync` m16n8k16 with the score accumulators handed
//    to the next product's A operand in registers (its redesign for wgmma
//    is queued in ROADMAP.md).
//  * float32: FMAs on the CUDA cores (TF32 would break the float32
//    tolerance).
#include "dropout.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

constexpr int THREADS = 256;      // float32 bodies: 4 threads per row
constexpr int MMA_THREADS = 128;  // bf16 bodies: 4 warps x 16 rows
constexpr int PS = 64 + 4;        // padded row stride of a 64-wide f32 tile

__device__ __forceinline__ float rowdot4(const float* a, const float* b,
                                         int dmax, float acc) {
  for (int d = 0; d < dmax; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// acc[4 * i + e] += w * row[4 * (g + 4 * i) + e]: a thread's float4 groups
template <int NG>
__device__ __forceinline__ void axpy_groups(float* acc, float w,
                                            const float* row, int g) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * (g + 4 * i));
    acc[4 * i + 0] = fmaf(w, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

template <int NG, typename T>
__device__ __forceinline__ void store_groups(T* dst, const float* acc, int g,
                                             int D) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (g + 4 * i) + e;
      if (d < D) dst[d] = from_f<T>(acc[4 * i + e]);
    }
}

// ---- float32 dq -------------------------------------------------------------

template <int DMAX> struct DqSmem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int bytes = (4 * 64 * SD + 64 * PS) * 4 + 64 * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int H,
              int Lq, int Lk, int D, float sm_scale, int causal,
              DropoutArgs drop) {
  constexpr int SD = DqSmem<DMAX>::SD;
  constexpr int NG = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + 64 * SD;             // dO tile
  float* Ks = Gs + 64 * SD;
  float* Vs = Ks + 64 * SD;
  float* DSs = Vs + 64 * SD;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(DSs + 64 * PS);

  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * BM;
  const int tid = threadIdx.x, row = tid >> 2, g = tid & 3;
  const int qrow = q0 + row;
  const int off = Lk - Lq;
  const float* brow = bias + (size_t)b * Lk;
  const int nq = min(BM, Lq - q0);
  load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
  load_tile_f32<DMAX, THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq, D);
  const float lse_r = qrow < Lq ? lse[(size_t)bh * Lq + qrow] : 0.f;
  const float delta_r = qrow < Lq ? delta[(size_t)bh * Lq + qrow] : 0.f;
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                     // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_f32<DMAX, THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
    load_tile_f32<DMAX, THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float* dsrow = DSs + row * PS;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int cl = g + 4 * j, c = k0 + cl;
      float ds = 0.f;
      if (c < Lk) {
        float x = rowdot4(Qs + row * SD, Ks + cl * SD, DMAX, 0.f) * sm_scale +
                  brow[c];
        if (causal && c > qrow + off) x = kNeg;
        const float p = expf(x - lse_r);
        float dp = rowdot4(Gs + row * SD, Vs + cl * SD, DMAX, 0.f);
        if (drop.on) dp = tile_keep(Mk, row, cl) ? dp * drop.inv_keep : 0.f;
        ds = p * (dp - delta_r) * sm_scale;
      }
      dsrow[cl] = ds;
    }
    __syncwarp();                        // a row's ds is written by its warp
    for (int c = 0; c < nk; ++c) axpy_groups<NG>(acc, dsrow[c], Ks + c * SD, g);
  }
  if (qrow < Lq) store_groups<NG>(dq + ((size_t)bh * Lq + qrow) * D, acc, g, D);
}

// ---- float32 dk, dv ---------------------------------------------------------

template <int DMAX> struct DkvSmem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int bytes =
      (4 * 64 * SD + 2 * 64 * PS + 2 * 64) * 4 + 64 * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Lq, int Lk, int D,
               float sm_scale, int causal, DropoutArgs drop) {
  constexpr int SD = DkvSmem<DMAX>::SD;
  constexpr int NG = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * SD;
  float* Qs = Vs + 64 * SD;
  float* Gs = Qs + 64 * SD;              // dO tile
  float* PTs = Gs + 64 * SD;             // p~^T (keys x queries)
  float* DSTs = PTs + 64 * PS;           // ds^T
  float* Ls = DSTs + 64 * PS;            // lse of the q tile
  float* Es = Ls + 64;                   // delta of the q tile
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Es + 64);

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, kr = tid >> 2, g = tid & 3;
  const int kcol = k0 + kr;
  const int off = Lk - Lq;
  const int nk = min(BN, Lk - k0);
  load_tile_f32<DMAX, THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
  load_tile_f32<DMAX, THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
  const float bias_k = kcol < Lk ? bias[(size_t)b * Lk + kcol] : 0.f;
  int lo = 0;
  if (causal && off >= 0) lo = max(0, k0 - off) / BM * BM;

  float dka[4 * NG], dva[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = lo; q0 < Lq; q0 += BM) {
    __syncthreads();                     // last tile's readers are done
    const int nq = min(BM, Lq - q0);
    load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
    load_tile_f32<DMAX, THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq, D);
    if (tid < 64) {                      // rows past Lq get p = 0
      Ls[tid] = tid < nq ? lse[(size_t)bh * Lq + q0 + tid] : INFINITY;
      Es[tid] = tid < nq ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
    }
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float* ptrow = PTs + kr * PS;
    float* dsrow = DSTs + kr * PS;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int ql = g + 4 * j, qi = q0 + ql;
      float x = rowdot4(Ks + kr * SD, Qs + ql * SD, DMAX, 0.f) * sm_scale +
                bias_k;
      if (causal && kcol > qi + off) x = kNeg;
      const float p = expf(x - Ls[ql]);
      float dp = rowdot4(Vs + kr * SD, Gs + ql * SD, DMAX, 0.f);
      float pv = p;
      if (drop.on) {
        const bool keep = tile_keep(Mk, ql, kr);
        pv = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      ptrow[ql] = pv;
      dsrow[ql] = p * (dp - Es[ql]) * sm_scale;
    }
    __syncwarp();                        // a key's row is written by its warp
    for (int c = 0; c < nq; ++c) {
      axpy_groups<NG>(dva, ptrow[c], Gs + c * SD, g);
      axpy_groups<NG>(dka, dsrow[c], Qs + c * SD, g);
    }
  }
  if (kcol < Lk) {
    store_groups<NG>(dk + ((size_t)bh * Lk + kcol) * D, dka, g, D);
    store_groups<NG>(dv + ((size_t)bh * Lk + kcol) * D, dva, g, D);
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

// ---- bfloat16 dk, dv on the tensor cores -----------------------------------

template <int DMAX> struct MmaDkvSmem {
  static constexpr int SK = Bf16Rows<DMAX>::SK;
  static constexpr int bytes = 4 * 64 * SK * 2 + 2 * 64 * 4 + 64 * kMaskGroups;
};

// warp w owns keys k0 + 16w .. k0 + 16w + 15 and computes the transposed
// tiles S^T = k.q^T and dP^T = v.dO^T, whose accumulators are then the A
// operands of dv += p~^T.dO and dk += ds^T.q
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int H, int Lq, int Lk, int D, float sm_scale, int causal,
               DropoutArgs drop) {
  constexpr int SK = MmaDkvSmem<DMAX>::SK;
  constexpr int KQ = DMAX / 16;
  constexpr int NO = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 64 * SK;
  __nv_bfloat16* Qs = Vs + 64 * SK;
  __nv_bfloat16* Gs = Qs + 64 * SK;      // dO tile
  float* Ls = reinterpret_cast<float*>(Gs + 64 * SK);   // lse of the q tile
  float* Es = Ls + 64;                                  // delta of the q tile
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Es + 64);

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kl0 = warp * 16 + gid, kl1 = kl0 + 8;      // this thread's keys
  const int off = Lk - Lq;
  const int nk = min(BN, Lk - k0);
  load_tile_bf16<DMAX, MMA_THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
  load_tile_bf16<DMAX, MMA_THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
  const float* brow = bias + (size_t)b * Lk;
  const float bk0 = k0 + kl0 < Lk ? brow[k0 + kl0] : 0.f;
  const float bk1 = k0 + kl1 < Lk ? brow[k0 + kl1] : 0.f;
  int lo = 0;
  if (causal && off >= 0) lo = max(0, k0 - off) / BM * BM;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int q0 = lo; q0 < Lq; q0 += BM) {
    __syncthreads();                     // last tile's readers are done
    const int nq = min(BM, Lq - q0);
    load_tile_bf16<DMAX, MMA_THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
    load_tile_bf16<DMAX, MMA_THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq,
                                      D);
    if (threadIdx.x < 64) {              // rows past Lq get p = 0
      const int t = threadIdx.x;
      Ls[t] = t < nq ? lse[(size_t)bh * Lq + q0 + t] : INFINITY;
      Es[t] = t < nq ? delta[(size_t)bh * Lq + q0 + t] : 0.f;
    }
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, MMA_THREADS);
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    {
      uint32_t af[KQ][4];
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) load_a_frag<SK>(af[kk], Ks, warp * 16, kk * 16);
      mma_rows_t<DMAX>(st, af, Qs);      // k.q^T
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) load_a_frag<SK>(af[kk], Vs, warp * 16, kk * 16);
      mma_rows_t<DMAX>(dpt, af, Gs);     // v.dO^T
    }

    // accumulator (j, e): key e < 2 ? kl0 : kl1, query q0 + 8j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + tig * 2 + (e & 1);
        const int kl = e < 2 ? kl0 : kl1;
        float x = st[j][e] * sm_scale + (e < 2 ? bk0 : bk1);
        if (causal && k0 + kl > q0 + ql + off) x = kNeg;
        const float p = expf(x - Ls[ql]);
        float dp = dpt[j][e], pv = p;
        if (drop.on) {
          const bool keep = tile_keep(Mk, ql, kl);
          pv = keep ? p * drop.inv_keep : 0.f;
          dp = keep ? dp * drop.inv_keep : 0.f;
        }
        st[j][e] = pv;
        dpt[j][e] = p * (dp - Es[ql]) * sm_scale;
      }
    }
    mma_acc_rows<DMAX>(dva, st, Gs);     // dv += p~^T (rounded) . dO
    mma_acc_rows<DMAX>(dka, dpt, Qs);    // dk += ds^T (rounded) . q
  }

#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (d < D) {
      const int c0 = k0 + kl0, c1 = k0 + kl1;
      if (c0 < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)bh * Lk + c0) * D + d) =
            __floats2bfloat162_rn(dka[dt][0], dka[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)bh * Lk + c0) * D + d) =
            __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      }
      if (c1 < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)bh * Lk + c1) * D + d) =
            __floats2bfloat162_rn(dka[dt][2], dka[dt][3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)bh * Lk + c1) * D + d) =
            __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
      }
    }
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
  dim3 grid(a.B * a.H, (a.Lq + BM - 1) / BM);
  cudaError_t e;
  if (dtype == kF32) {
    static bool configured = false;
    constexpr int bytes = DqSmem<DMAX>::bytes;
    if ((e = allow_smem(dq_f32_kernel<DMAX>, bytes, configured))) return e;
    dq_f32_kernel<DMAX><<<grid, THREADS, bytes, a.stream>>>(
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
  dim3 grid(a.B * a.H, (a.Lk + BN - 1) / BN);
  cudaError_t e;
  if (dtype == kF32) {
    static bool configured = false;
    constexpr int bytes = DkvSmem<DMAX>::bytes;
    if ((e = allow_smem(dkv_f32_kernel<DMAX>, bytes, configured))) return e;
    dkv_f32_kernel<DMAX><<<grid, THREADS, bytes, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.bias, (const float*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (float*)dk, (float*)dv, a.H, a.Lq, a.Lk, a.D,
        a.sm_scale, a.causal, a.drop);
  } else {
    static bool configured = false;
    constexpr int bytes = MmaDkvSmem<DMAX>::bytes;
    if ((e = allow_smem(dkv_mma_kernel<DMAX>, bytes, configured))) return e;
    dkv_mma_kernel<DMAX><<<grid, MMA_THREADS, bytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const float*)a.bias,
        (const __nv_bfloat16*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a.H,
        a.Lq, a.Lk, a.D, a.sm_scale, a.causal, a.drop);
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
