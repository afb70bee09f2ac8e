// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of
// mxnet_tpu/pallas_ops/flash_attention.py (launched by `_flash_fwd_pallas`):
// scores = q.k^T * sm_scale + bias[b, key], then the causal
// mask aligned so the last query sees the last key (offset Lk - Lq; masked
// scores are REPLACED by -1e30), an online softmax with a running max and
// denominator in float32, P rounded to the model dtype before P.V, and the
// output O (in q's dtype) plus the row log-sum-exp (float32), which the
// backward kernels (flash_bwd.cu) read. Attention dropout follows the TPU
// kernel exactly: the denominator l and the LSE sum the UNDROPPED p; only
// the P.V accumulation sees the kept p scaled by 1/(1-p). The keep bits
// come from the coordinate-keyed Philox of dropout.cuh.
//
// What bounds it: a pass does 4*Lq*Lk*D operations per (b, h) (half that
// when causal) for 4*L*D elements moved. By the repo's count (chip_smoke.py
// `bound`: each input read once, each output written once) it is bound by
// bytes at the main path's L of 512 and 1,024 at D = 64: 128 operations
// per byte at L = 512 non-causal, against the ~295 the card's bf16 tensor
// cores need. The L x L score matrix stays out of device memory, as on the
// TPU, and ragged Lq and Lk are masked in the kernel, so nothing is padded.
// Against the byte bound the bf16 body keeps TMA loads in flight ahead of
// the math, and reads a head's K and V from device memory about once (its
// q tiles are neighbours in the work order; causal work runs longest
// first instead, and reads them again from L2 or device memory).
//
// Two bodies, chosen by dtype:
//  * bfloat16 (the serving and training dtype): `flash_fwd_wgmma_kernel`,
//    persistent and warp-specialised. One producer warp streams each work
//    item's Q and its K/V tiles from device memory by TMA into shared
//    memory (a ring of stages on mbarriers, Q double-buffered), so loads
//    run ahead of the math and across items; the consumer warpgroups (64
//    query rows each: three at D <= 64, two at D <= 128) issue wgmma, which
//    reads Q and K from shared memory and P from registers. The
//    softmax runs in the exp2 domain (sm_scale * log2 e folded into one
//    FMA, the bias tile staged by TMA), the causal compare only on tiles
//    across the diagonal, and the dropout bits are made in registers while
//    S = Q.K^T runs. O goes out through shared memory by TMA store, which
//    writes no row past Lq and no column past D.
//    ptxas (CUDA 12.9, -Xptxas -v): 128 registers at entry at D <= 64 and
//    168 at D <= 128, 0 bytes spilled; setmaxnreg then gives the consumers
//    160 (three warpgroups) or 240 (two) and the producer 24.
//  * float32 runs float32 FMAs on the CUDA cores until its own redesign
//    (TF32 alone keeps 10 mantissa bits; split TF32, three TF32 products a
//    float32 product, holds float32's accuracy on the tensor cores, as the
//    backward's float32 bodies in flash_bwd.cu do): 256 threads,
//    thread (row = tid/4, g = tid%4) owns score columns g + 4j of its row
//    and the output float4 groups g + 4i; the threads that share a row are
//    neighbouring lanes, so row max and row sum are two shuffles.
#include "dropout.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

constexpr int THREADS = 256;
constexpr int PS = BN + 4;    // padded row stride of the P tile

// ---- float32 on the CUDA cores ----------------------------------------------

template <int DMAX> struct Smem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int floats = BM * SD + 2 * BN * SD + BM * PS;
  static constexpr int bytes = floats * 4 + BM * kMaskGroups;  // + keep mask
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, int D, float sm_scale, int causal, DropoutArgs drop) {
  constexpr int SD = Smem<DMAX>::SD;
  constexpr int NJ = BN / 4;       // score columns per thread
  constexpr int NG = DMAX / 16;    // output float4 groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * SD;
  float* Vs = Ks + BN * SD;
  float* Ps = Vs + BN * SD;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Ps + BM * PS);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int row = tid >> 2, g = tid & 3;
  const int qrow = q0 + row;
  const int off = Lk - Lq;                 // causal alignment offset
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  const float* brow = bias + (size_t)b * Lk;

  load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D,
                               min(BM, Lq - q0), D);

  // a causal tile stops at the last key its last real row sees; with
  // Lq > Lk some rows see no key and average over all of them (the
  // reference's fully-masked-row semantics), so the loop then runs full
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                       // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_f32<DMAX, THREADS>(Ks, kb + (size_t)k0 * D, nk, D);
    load_tile_f32<DMAX, THREADS>(Vs, vb + (size_t)k0 * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    const float* qr = Qs + row * SD;
#pragma unroll 2
    for (int d = 0; d < DMAX; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (g + 4 * j) * SD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + g + 4 * j;
      float x;
      if (c >= Lk) {
        x = -INFINITY;                     // past the keys: zero weight
      } else {
        x = s[j] * sm_scale + brow[c];
        if (causal && c > qrow + off) x = kNeg;
      }
      s[j] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    float* prow = Ps + row * PS;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - m_new);
      ls += p;                             // the denominator sums unrounded p
      prow[g + 4 * j] =                    // P.V sees the kept, scaled p
          drop.on ? (tile_keep(Mk, row, g + 4 * j) ? p * drop.inv_keep : 0.f)
                  : p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= alpha;
    __syncwarp();                          // a row's P is written by its warp

    for (int c = 0; c < nk; ++c) {
      const float p = prow[c];
      const float* vr = Vs + c * SD;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (g + 4 * i));
        acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (qrow < Lq) {
    l = fmaxf(l, 1e-30f);
    float* orow = o + ((size_t)bh * Lq + qrow) * D;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (g + 4 * i) + e;
        if (d < D) orow[d] = acc[4 * i + e] / l;
      }
    }
    if (g == 0) lse[(size_t)bh * Lq + qrow] = m + logf(l);
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int H,
                       int Lq, int Lk, int D, float sm_scale, int causal,
                       const DropoutArgs& drop, cudaStream_t stream) {
  constexpr int bytes = Smem<DMAX>::bytes;
  static bool configured = false;          // above 48 KB needs an opt-in
  cudaError_t e = allow_smem(flash_fwd_kernel<DMAX>, bytes, configured);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Lq + BM - 1) / BM);
  flash_fwd_kernel<DMAX><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), H, Lq, Lk, D, sm_scale,
      causal, drop);
  return cudaGetLastError();
}

// ---- bfloat16: TMA-fed wgmma, warp-specialised, persistent ------------------

constexpr int FW_KEYS = 128;     // keys of a K/V tile

// shared memory of a block, every tile on a 1024-byte boundary: two Q
// buffers (the item in work and the next) as [buffer][warpgroup][64-column
// chunk][64 rows], a ring of K and V tiles as [stage][chunk][128 keys],
// the bias of each stage's keys, the barriers
template <int DMAX> struct FwdPlan {
  static constexpr int NCH = DMAX / 64;
  // consumer warpgroups (64 query rows each) and their registers: three at
  // D <= 64, where S, O and P fit in 160; two at D <= 128, with 240. The
  // producer warpgroup comes last and keeps 24.
  static constexpr int NWG = DMAX == 64 ? 3 : 2;
  static constexpr int REGS = DMAX == 64 ? 160 : 240;
  static constexpr int ROWS = 64 * NWG;               // rows of a work item
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int STAGES = DMAX == 64 ? 3 : 2;
  static constexpr int Q_TILE = 64 * 128;             // 64 rows x 128 bytes
  static constexpr int Q_BUF = NWG * NCH * Q_TILE;    // one item's Q
  static constexpr int KV_CHUNK = FW_KEYS * 128;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;     // one K (or V) tile
  // a stage's bias: FW_KEYS + 4 values from the 16-byte boundary at or
  // below the tile's first key (a TMA box starts on a 16-byte boundary)
  static constexpr int BIAS_BOX = FW_KEYS + 4;
  static constexpr int BIAS_BYTES = 640;              // a 128-byte multiple
  static constexpr int K_OFF = 2 * Q_BUF;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int B_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = B_OFF + STAGES * BIAS_BYTES;
  static constexpr int bytes = BAR_OFF + (4 + 2 * STAGES) * 8 + 1024;
};

// A work item is one (b*h, ROWS-row q tile). Causal items run longest
// first; otherwise the q tiles of one head are neighbours, so its K and V
// come from device memory once and from L2 for the rest.
template <int ROWS> struct FwdItem {
  int bh, q0, ntiles;
  __device__ FwdItem(int i, int BH, int nq, int Lq, int Lk, int causal) {
    int qt;
    if (causal) {
      qt = nq - 1 - i / BH;
      bh = i % BH;
    } else {
      bh = i / nq;
      qt = i % nq;
    }
    q0 = qt * ROWS;
    // a causal item stops at the last key its last row sees; with Lq > Lk
    // some rows see no key and average over all of them, so it runs full
    int hi = Lk;
    if (causal && Lk >= Lq) hi = min(Lk, min(q0 + ROWS, Lq) + Lk - Lq);
    ntiles = (hi + FW_KEYS - 1) / FW_KEYS;
  }
};

// Persistent: each block walks the items blockIdx.x, + gridDim.x, ...
// The producer warpgroup's first thread loads, running ahead across items:
// an item's Q into the free Q buffer, then K, V and the bias of each key
// tile into the next free stage of the ring (full/empty mbarriers). Each
// consumer warpgroup
// owns 64 query rows of an item: S = Q.K^T by wgmma from shared memory
// (the tile's keep bits are computed while it runs), the online softmax in
// the exp2 domain in registers, P rounded to bf16 in registers as the A
// operand of O += P.V, then the stage goes back to the producer. O leaves
// through the warpgroup's Q tiles and a TMA store, and the Q buffer goes
// back, while the producer already loads the next item.
template <int DMAX>
__global__ void __launch_bounds__(FwdPlan<DMAX>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int BH, int H, int Lq, int Lk,
                       float sm_scale, int causal, DropoutArgs drop) {
  using P = FwdPlan<DMAX>;
  constexpr int NCH = P::NCH, S = P::STAGES, NWG = P::NWG;
  using Item = FwdItem<P::ROWS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + S;
  const int nq = (Lq + P::ROWS - 1) / P::ROWS;
  const int items = BH * nq;
  const int off = Lk - Lq;                 // causal alignment offset

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
      int g = 0;                           // K/V tiles over all items
      for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
        const Item w(i, BH, nq, Lq, Lk, causal);
        const int qb = it & 1, b = w.bh / H;
        uint8_t* qs = base + qb * P::Q_BUF;
        mbar_wait(&qempty[qb], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], P::Q_BUF);
        for (int r = 0; r < NWG; ++r)
          for (int c = 0; c < NCH; ++c)
            tma_load_3d(qs + (r * NCH + c) * P::Q_TILE, &tq, &qfull[qb],
                        64 * c, w.q0 + 64 * r, w.bh);
        for (int t = 0; t < w.ntiles; ++t, ++g) {
          const int s = g % S;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * P::KV_BYTES + 4 * P::BIAS_BOX);
          for (int c = 0; c < NCH; ++c) {
            tma_load_3d(base + P::K_OFF + s * P::KV_BYTES + c * P::KV_CHUNK,
                        &tk, &full[s], 64 * c, t * FW_KEYS, w.bh);
            tma_load_3d(base + P::V_OFF + s * P::KV_BYTES + c * P::KV_CHUNK,
                        &tv, &full[s], 64 * c, t * FW_KEYS, w.bh);
          }
          // bias row b is b*Lk.. of the flat (B*Lk) map; keys past Lk
          // read the next row or zeros, and are masked
          tma_load_1d(base + P::B_OFF + s * P::BIAS_BYTES, &tb, &full[s],
                      (b * Lk + t * FW_KEYS) & ~3);
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
  float o[NCH][32], sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  int g = 0;
  for (int i = blockIdx.x, it = 0; i < items; i += gridDim.x, ++it) {
    const Item w(i, BH, nq, Lq, Lk, causal);
    const int qb = it & 1, bh = w.bh, b = bh / H;
    const int qw = w.q0 + 64 * wg;         // this warpgroup's first row
    const int r0 = qw + 16 * warp + gid, r1 = r0 + 8;   // this thread's rows
    int my_tiles = 0;                      // the key tiles these rows need
    if (qw < Lq) {
      int hi_w = Lk;
      if (causal && off >= 0) hi_w = min(Lk, min(qw + 64, Lq) + off);
      my_tiles = (hi_w + FW_KEYS - 1) / FW_KEYS;
    }
    uint8_t* qs = base + qb * P::Q_BUF + wg * NCH * P::Q_TILE;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int k = 0; k < 32; ++k) o[c][k] = 0.f;
    float m0 = kNeg2, m1 = kNeg2, l0 = 0.f, l1 = 0.f;   // l: this thread's
    mbar_wait(&qfull[qb], (it >> 1) & 1);

    for (int t = 0; t < w.ntiles; ++t, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      if (t < my_tiles) {
        const int k0 = t * FW_KEYS;
        const uint8_t* ks = base + P::K_OFF + s * P::KV_BYTES;
        const uint8_t* vs = base + P::V_OFF + s * P::KV_BYTES;
        const float* bsm = reinterpret_cast<const float*>(
                               base + P::B_OFF + s * P::BIAS_BYTES) +
                           ((b * Lk + k0) & 3);

        // S = Q.K^T: 16-column steps along the head dim of each chunk
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128(sacc, sw128_desc(qs + c * P::Q_TILE + 32 * kk, 16),
                          sw128_desc(ks + c * P::KV_CHUNK + 32 * kk, 16),
                          c + kk > 0);
        wg_commit();
        uint32_t keep[2] = {0u, 0u};        // while the tensor cores run
        if (drop.on) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            keep[j >> 3] |= keep_quad(drop, bh, r0, r1, k0 + 8 * j + 2 * tig,
                                      tig) << (4 * (j & 7));
        }
        wg_wait<0>();
        wg_hold(sacc);

        // accumulator 4j + e: row e < 2 ? r0 : r1, key k0 + 8j + 2 tig +
        // (e & 1); x = log2 e * (s * sm_scale + bias), masked scores
        // replaced (the causal compare only on tiles across the diagonal)
        const bool masked =
            k0 + FW_KEYS > Lk || (causal && k0 + FW_KEYS - 1 > qw + off);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * tig;
          const float b0 = __fmul_rn(bsm[col], kLog2e);
          const float b1 = __fmul_rn(bsm[col + 1], kLog2e);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(sacc[4 * j + e], scale2, (e & 1) ? b1 : b0);
            if (masked) {
              const int c = k0 + col + (e & 1);
              if (causal && c > (e < 2 ? r0 : r1) + off) x = kNeg2;
              if (c >= Lk) x = -INFINITY;  // past the keys: zero weight
            }
            sacc[4 * j + e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        l0 *= a0;
        l1 *= a1;

        // p: the denominator sums it unrounded; P.V sees the kept p
        // scaled, rounded to bf16 in the A layout (keys 16kk.. = pf[4kk..])
        uint32_t pf[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = ex2(sacc[4 * j + e] - (e < 2 ? m0 : m1));
          l0 += p[0] + p[1];
          l1 += p[2] + p[3];
          if (drop.on) {
            const uint32_t kb = keep[j >> 3] >> (4 * (j & 7));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = (kb >> e) & 1u ? p[e] * drop.inv_keep : 0.f;
          }
          pf[2 * j] = pack_bf16(p[0], p[1]);
          pf[2 * j + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j] *= a0;
            o[c][4 * j + 1] *= a0;
            o[c][4 * j + 2] *= a1;
            o[c][4 * j + 3] *= a1;
          }

        // O += P.V: V is key-major, so B is MN-major (the transpose bit)
#pragma unroll
        for (int c = 0; c < NCH; ++c) wg_hold(o[c]);
        wg_hold(pf);
        wg_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                                   pf[4 * kk + 3]};
            wgmma_rs_n64_t(o[c], a,
                           sw128_desc(vs + c * P::KV_CHUNK + kk * 2048,
                                      P::KV_CHUNK),
                           1);
          }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NCH; ++c) wg_hold(o[c]);
        wg_hold(pf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage goes back
    }

    // ---- epilogue: O / l as bf16 through this warpgroup's Q tiles
    if (my_tiles > 0) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      l0 = fmaxf(l0, 1e-30f);
      l1 = fmaxf(l1, 1e-30f);
      const float i0 = 1.f / l0, i1 = 1.f / l1;
      named_sync(1 + wg, 128);             // every warp is done with Q
      __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(qs);
      const int rl0 = 16 * warp + gid, rl1 = rl0 + 8;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(os + c * 64 * 64 + sw128(rl0, col)) =
              pack_bf16(o[c][4 * j] * i0, o[c][4 * j + 1] * i0);
          *reinterpret_cast<uint32_t*>(os + c * 64 * 64 + sw128(rl1, col)) =
              pack_bf16(o[c][4 * j + 2] * i1, o[c][4 * j + 3] * i1);
        }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (wt == 0) {                       // rows past Lq are not written
        for (int c = 0; c < NCH; ++c)
          tma_store_3d(&to, os + c * 64 * 64, 64 * c, qw, bh);
        tma_store_drain();
      }
      // a row whose every key is masked has max kNeg2: its LSE is the
      // reference's -1e30 exactly, so the backward's exp(x - lse) is 1
      if (tig == 0) {
        if (r0 < Lq)
          lse[(size_t)bh * Lq + r0] =
              m0 == kNeg2 ? kNeg : (m0 + log2f(l0)) * kLn2;
        if (r1 < Lq)
          lse[(size_t)bh * Lq + r1] =
              m1 == kNeg2 ? kNeg : (m1 + log2f(l1)) * kLn2;
      }
    }
    if (wt == 0) mbar_arrive(&qempty[qb]);   // the Q buffer goes back
  }
}

template <int DMAX>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int H,
                         int Lq, int Lk, int D, float sm_scale, int causal,
                         const DropoutArgs& drop, cudaStream_t stream) {
  const int BH = B * H;
  CUtensorMap tq, tk, tv, tb, to;
  if (!map_rows_bf16(&tq, q, BH, Lq, D, 64) ||
      !map_rows_bf16(&tk, k, BH, Lk, D, FW_KEYS) ||
      !map_rows_bf16(&tv, v, BH, Lk, D, FW_KEYS) ||
      !map_flat_f32(&tb, bias, (size_t)B * Lk, FwdPlan<DMAX>::BIAS_BOX) ||
      !map_rows_bf16(&to, o, BH, Lq, D, 64))
    return cudaErrorInvalidValue;
  constexpr int bytes = FwdPlan<DMAX>::bytes;
  static bool configured = false;          // above 48 KB needs an opt-in
  cudaError_t e = allow_smem(flash_fwd_wgmma_kernel<DMAX>, bytes, configured);
  if (e != cudaSuccess) return e;
  using P = FwdPlan<DMAX>;
  const int grid = persistent_grid(BH * ((Lq + P::ROWS - 1) / P::ROWS));
  flash_fwd_wgmma_kernel<DMAX><<<grid, P::THREADS, bytes, stream>>>(
      tq, tk, tv, tb, to, static_cast<float*>(lse), BH, H, Lq, Lk, sm_scale,
      causal, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// q (B,H,Lq,D), k/v (B,H,Lk,D) contiguous, dtype 0 = float32, 1 = bfloat16;
// bias (B,Lk) float32; o like q; lse (B*H, Lq) float32. D % 8 == 0, D <= 128.
// Dropout (p > 0 when dropout_on): keep where Philox bits >= threshold,
// kept p scaled by inv_keep (dropout.cuh). Returns the CUDA error of the
// launch (0 on success).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, void* lse, int B, int H,
                            int Lq, int Lk, int D, float sm_scale, int causal,
                            int dtype, uint32_t seed_lo, uint32_t seed_hi,
                            uint32_t threshold, float inv_keep, int dropout_on,
                            void* stream) {
  using namespace mxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  const DropoutArgs drop{seed_lo, seed_hi, threshold, inv_keep, dropout_on};
  if (dtype == kF32) {
    return D <= 64 ? launch_f32<64>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                    sm_scale, causal, drop, s)
                   : launch_f32<128>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                     sm_scale, causal, drop, s);
  }
  if (dtype == kBF16) {
    return D <= 64 ? launch_wgmma<64>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                    sm_scale, causal, drop, s)
                   : launch_wgmma<128>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                     sm_scale, causal, drop, s);
  }
  return cudaErrorInvalidValue;
}

namespace {

__global__ void dropout_mask_kernel(uint8_t* __restrict__ out, int Lq, int Lk,
                                    mxt::DropoutArgs drop) {
  const int bh = blockIdx.z;
  const int r = blockIdx.y;
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * grp >= Lk) return;
  const uint32_t nib = mxt::keep_nibble(drop, bh, r, grp);
  uint8_t* row = out + ((size_t)bh * Lq + r) * Lk;
  for (int j = 0; j < 4 && 4 * grp + j < Lk; ++j)
    row[4 * grp + j] = (nib >> j) & 1;
}

}  // namespace

// The keep mask itself, (BH, Lq, Lk) uint8 (1 = keep), from the same device
// function the attention kernels use: lets a test hold the kernels' mask
// against the plain version bit for bit. Not on any model path.
extern "C" int mx_dropout_mask(void* out, int BH, int Lq, int Lk,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t threshold, void* stream) {
  if (BH <= 0 || Lq <= 0 || Lk <= 0 || BH > 65535 || Lq > 65535)
    return cudaErrorInvalidValue;
  const mxt::DropoutArgs drop{seed_lo, seed_hi, threshold, 1.f, 1};
  const int groups = (Lk + 3) / 4;
  dim3 grid((groups + 127) / 128, Lq, BH);
  dropout_mask_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), Lq, Lk, drop);
  return cudaGetLastError();
}
