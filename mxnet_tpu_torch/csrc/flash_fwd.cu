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
// first instead, and reads them again from L2 or device memory). In
// float32 both products run in split TF32, three TF32 products a float32
// product, so its operations count at a third of the TF32 rate (165
// TFLOP/s, chip_smoke.py `SPLIT_TF32_FLOPS`): at SQuAD fine-tuning's L =
// 384 with a padding mask that bound is operations, at L = 128 bytes.
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
//  * float32: `flash_fwd_split_tf32_kernel`, both products on the tensor
//    cores in split TF32 (flash_common.cuh, the blocks of the backward's
//    float32 bodies in flash_bwd.cu): each operand is big = tf32(x) plus
//    small = tf32(x - big), and a product is three m16n8k8 mma.sync
//    (HMMA.1688.F32.TF32), small terms first, summed two k-steps at a
//    time into a fresh partial added in float32 (the tensor cores
//    truncate each accumulation). That holds float32's accuracy where
//    TF32 alone (10 mantissa bits) misses the 1e-4 gate (3.4e-4 on O in
//    tests/test_torch_flash_split_tf32.py's emulation at SQuAD's L =
//    384). A block owns ROWS query rows (8 warps x 16 at D <= 64, 4 x 16
//    at D <= 128), raw in shared memory, their A fragments split as they
//    load; it walks K and V in tiles of 32 keys, two cp.async stages,
//    each with its keys' bias: tile i + 1 is in flight while tile i's
//    products run, each thread splits in place the 16-byte chunks it
//    copied, then one barrier a tile. S = Q.K^T reads K's split tile as B
//    (`score_tile`); the online softmax runs in the exp2 domain in
//    registers, the keep bits made there too (`keep_quad`); the kept,
//    scaled p is the A operand of O += P.V where it stands in the score
//    accumulators, V's split tile B with the contraction over its rows
//    (`grad_tile`). Both products interleave four output tiles' chains.
//    Every key tile is computed, padded or not: a row whose every key is
//    masked has p = 1 for each, not 0.
//    What bounds it: the warps of a block run the same phase at once
//    (split, products, softmax and keep bits), so with one block an SM
//    the tensor cores wait through the others. At D <= 64 the 32-key
//    tiles keep a block to 96 KB of shared memory and 128 registers a
//    thread, and two blocks share an SM, out of step.
#include "dropout.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"

namespace mxt {
namespace {

// ---- float32: split TF32 on mma.sync (flash_common.cuh) -------------------

// The forward owns one tensor (Q) and walks two (K and V, with the key
// bias), in tiles of 32 keys: at D <= 64 a block then takes 96 KB of
// shared memory and at most 128 registers a thread, so two blocks (16
// warps) share an SM and one block's softmax runs beside the other's
// products (one block an SM with 64-key tiles took 12-19% longer at
// SQuAD's and BERT-base's shapes on an H100, chip_smoke.py --flash-times)
template <int DMAX> using FwdF32Plan = F32Plan<DMAX, 1, 1, 32>;

// A block: ROWS query rows of one (b, h), 16 a warp. Thread (g, t) of a
// warp holds rows r0 = g and r1 = g + 8 of the warp's 16: score columns
// 8j + 2t + (e & 1) of sc[j][e] and output columns 8i + 2t + (e & 1) of
// acc[i][e], row r0 for e < 2, else r1. Its running max m and its share
// of the denominator l are per row; the four lanes of a row (one g) agree
// on m by two shuffles a tile and sum l at the end.
template <int DMAX>
__global__ void __launch_bounds__(FwdF32Plan<DMAX>::THREADS, DMAX == 64 ? 2 : 1)
flash_fwd_split_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int Lq, int Lk, int D, float sm_scale,
                            int causal, DropoutArgs drop) {
  using P = FwdF32Plan<DMAX>;
  constexpr int T = P::TILE;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // own rows: Q, raw
  float* walk = Qs + P::FIXED;           // stages: K, V split; key bias

  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * P::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp, r0 = q0 + wr + g, r1 = r0 + 8;
  const int off = Lk - Lq;               // causal alignment offset
  const float* kh = k + (size_t)bh * Lk * D;
  const float* vh = v + (size_t)bh * Lk * D;
  const float* brow = bias + (size_t)b * Lk;
  copy_tile_async<DMAX, P::THREADS, P::ROWS>(
      Qs, q + ((size_t)bh * Lq + q0) * D, min(P::ROWS, Lq - q0), D);
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
  // the keys the block's rows see: a causal block stops at its last row's
  // diagonal; with Lq > Lk some rows see no key and average over all of
  // them (the reference's fully-masked-row semantics), so it runs full
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + P::ROWS, Lq) + off);
  const int ntiles = (hi + P::TR - 1) / P::TR;
  load(0);
  int hi_w = 0;                          // the same for this warp's rows
  if (q0 + wr < Lq) {
    hi_w = Lk;
    if (causal && off >= 0) hi_w = min(Lk, min(q0 + wr + 16, Lq) + off);
  }
  const float scale2 = sm_scale * kLog2e;
  const FragOffsets<DMAX> fo(g, t);
  float acc[P::ND][4];
#pragma unroll
  for (int i = 0; i < P::ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // the reference's running max starts at -1e30: a row whose every key is
  // masked keeps it, and each of its keys then has p = 1
  float m0 = kNeg2, m1 = kNeg2, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    float* st = walk + (i & 1) * P::STAGE;
    cp_async_wait<0>();
    split_tile<DMAX, P::THREADS, P::TR>(st, st + T);
    split_tile<DMAX, P::THREADS, P::TR>(st + 2 * T, st + 3 * T);
    __syncthreads();                     // tile i is whole; tile i - 1 done
    if (i + 1 < ntiles) load(i + 1);
    const int k0 = i * P::TR;
    if (k0 >= hi_w) continue;

    float sc[P::NT][4];                  // S = Q.K^T
    score_tile<DMAX, P::NT, 4>(sc, Qs + wr * DMAX, st, st + T, D, fo);
    uint32_t keep = 0u;
    if (drop.on) {
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
        keep |= keep_quad(drop, bh, r0, r1, k0 + 8 * j + 2 * t, t) << (4 * j);
    }
    // x = log2 e * (s * sm_scale + bias); causal-masked scores replaced by
    // the reference's -1e30, keys past Lk get zero weight
    const float* bsm = st + 4 * T;
    float mx0 = m0, mx1 = m1;
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
        if (c >= Lk) x = -INFINITY;
        sc[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
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
    // p: the denominator sums it undropped; P.V sees the kept p scaled
#pragma unroll
    for (int j = 0; j < P::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sc[j][e] - (e < 2 ? m0 : m1));
        if (e < 2)
          l0 += p;
        else
          l1 += p;
        if (drop.on) p = (keep >> (4 * j + e)) & 1u ? p * drop.inv_keep : 0.f;
        sc[j][e] = p;
      }
#pragma unroll
    for (int d = 0; d < P::ND; ++d) {
      acc[d][0] *= a0;
      acc[d][1] *= a0;
      acc[d][2] *= a1;
      acc[d][3] *= a1;
    }
    grad_tile<DMAX, P::NT, 4>(acc, sc, st + 2 * T, st + 3 * T, D, fo);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < P::ND; ++i) {
    const int d = 8 * i + 2 * t;
    if (d >= D) break;
    if (r0 < Lq)
      *reinterpret_cast<float2*>(o + ((size_t)bh * Lq + r0) * D + d) =
          make_float2(acc[i][0] * i0, acc[i][1] * i0);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(o + ((size_t)bh * Lq + r1) * D + d) =
          make_float2(acc[i][2] * i1, acc[i][3] * i1);
  }
  // a row whose every key is masked has max kNeg2: its LSE is the
  // reference's -1e30 exactly, so the backward's exp(x - lse) is 1
  if (t == 0) {
    if (r0 < Lq)
      lse[(size_t)bh * Lq + r0] =
          m0 == kNeg2 ? kNeg : (m0 + log2f(l0)) * kLn2;
    if (r1 < Lq)
      lse[(size_t)bh * Lq + r1] =
          m1 == kNeg2 ? kNeg : (m1 + log2f(l1)) * kLn2;
  }
}

template <int DMAX>
cudaError_t launch_split_tf32(const void* q, const void* k, const void* v,
                              const void* bias, void* o, void* lse, int B,
                              int H, int Lq, int Lk, int D, float sm_scale,
                              int causal, const DropoutArgs& drop,
                              cudaStream_t stream) {
  using P = FwdF32Plan<DMAX>;
  static bool configured = false;          // above 48 KB needs an opt-in
  cudaError_t e =
      allow_smem(flash_fwd_split_tf32_kernel<DMAX>, P::bytes, configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Lq + P::ROWS - 1) / P::ROWS);
  flash_fwd_split_tf32_kernel<DMAX><<<grid, P::THREADS, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), H, Lq, Lk, D,
      sm_scale, causal, drop);
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
    return D <= 64 ? launch_split_tf32<64>(q, k, v, bias, o, lse, B, H, Lq,
                                           Lk, D, sm_scale, causal, drop, s)
                   : launch_split_tf32<128>(q, k, v, bias, o, lse, B, H, Lq,
                                            Lk, D, sm_scale, causal, drop, s);
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
