// Int8 GEMM with the per-channel rescale, bias and relu fused into its
// epilogue, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_kernel` of mxnet_tpu/pallas_ops/int8_matmul.py
// (launched by `_int8_matmul_pallas` from `int8_matmul`, which every
// `QuantizedDense` of a quantized model calls). It computes
//   out[m, o] = relu?( float(sum_k x[m, k] * w[k, o]) * s[o] + b[o] )
// with x (M, K) int8 row-major, w (K, O) int8 row-major (the JAX package's
// pre-transposed weight layout, kept so parameter names and shapes match),
// s[o] = x_scale * w_scale[o] and b (O,) float32, out (M, O) float32. The
// int32 accumulator never leaves the registers, as on the TPU it never
// left VMEM. It is exact: |acc| <= 128^2 * K < 2^31 for K < 131,072.
//
// The scale is formed in the kernel: x_scale is read from the device (a
// 0-d float32 or bfloat16 tensor: the dynamic activation scale is never
// read back to the host) or passed as a host float, and
// s[o] = __fmul_rn(float(x_scale), w_scale[o]) is torch's float32 product
// bit for bit, with no launch of its own. The epilogue is
// `__fadd_rn(__fmul_rn(__int2float_rn(acc), s[o]), b[o])`: explicit
// rounding intrinsics keep nvcc from contracting the multiply and add
// into one FMA, so the output equals the plain version's separate float32
// multiply and add bit for bit.
//
// What bounds it, and the three routes (the wrapper picks one and counts
// its launches):
//  * M <= 16 (every one-token decode step, and chunked prefill of 8): the
//    bytes of w, K*O, read once: 7.1 MB for a GPT-2 layer's four GEMMs,
//    2.1 us at 3.35 TB/s. The work is a few hundred kilobytes a GEMM, so
//    what costs is latency: every SM must have its share of w in flight at
//    once. `int8_decode_kernel` splits K over a thread-block cluster of up
//    to 8 blocks (grid (split, O / 32)), the split chosen so that (O / 32)
//    x split covers the 132 SMs twice where K allows: 288, 192, 384 and
//    192 blocks for GPT-2's (768, 2304), (768, 768), (768, 3072) and
//    (3072, 768). Each block streams
//    its k rows of a 32-column strip of w, with the matching x columns,
//    through an 8-stage cp.async ring (16-byte copies, 7 stages in flight
//    before the first product), and multiplies from shared memory, its B
//    rows swizzled so the byte gather is free of bank conflicts. Each rank
//    writes the int32 partials of the outputs another rank owns into that
//    rank's shared memory (distributed shared memory); after one cluster
//    barrier the owners sum and run the epilogue: exact in any order, so
//    the output stays bit for bit, with no second launch and no scratch
//    in device memory. The epilogue's scales and biases are loaded before
//    the K loop.
//  * M > 16 (prefill, generate's M = 4 x 128), K % 16 == 0: bytes again,
//    dominated by the float32 output (4 M O bytes): 41 MB and 12.2 us for
//    a GPT-2 layer's four GEMMs at M = 1024, against 7.9 us of int8
//    operations at 1,979 TOP/s. `int8_wgmma_kernel` runs int8 wgmma
//    (m64n128k32, s32 += s8 x s8), whose B operand must be K-major: it
//    reads w as the (O, K) K-major copy that QuantizedDense keeps beside
//    the JAX layout. One producer warp streams 128-byte-deep tiles of x
//    and of that copy by TMA (128-byte swizzle, zeros past M, O and K)
//    into a ring of stages on mbarriers; one or two consumer warpgroups
//    (64 rows of x each, 128 output columns) issue wgmma from shared
//    memory, keep one k step's products in flight while the next stage
//    lands, and write the epilogue from registers as float2 stores.
//    Two consumer warpgroups when the 128 x 128 tiles alone fill the
//    card, else one (64 x 128 tiles, twice the blocks); 96 KB of shared
//    memory a block, so two blocks share an SM and one's epilogue runs
//    under the other's loads.
//  * M > 16 where TMA cannot address the operands (K % 16 != 0, or x off
//    the 16-byte grid): `int8_gemm_kernel`, mma.sync m16n8k32 on 64 x 64
//    tiles with BK = 128 and 4 warps of 32 x 32; each block stages an x
//    tile and a w tile, w transposed to n-major (Bt[n][k]) on the way in,
//    rows padded by 16 bytes against bank conflicts, and loops over K with
//    synchronous loads.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace mxt {
namespace {

// the epilogue's scale: s[o] = x_scale * w_scale[o * ws_step]
struct Scale {
  const void* xs;     // 0-d x_scale on the device, or null
  int xs_bf16;        // xs holds a bfloat16 (else a float32)
  float xs_host;      // x_scale when xs is null
  const float* ws;    // w_scale, (O,) or (1,)
  int ws_step;        // 1: per channel; 0: one per tensor
};

__device__ __forceinline__ float x_scale_of(const Scale& sc) {
  if (sc.xs == nullptr) return sc.xs_host;
  return sc.xs_bf16
             ? __bfloat162float(*static_cast<const __nv_bfloat16*>(sc.xs))
             : *static_cast<const float*>(sc.xs);
}

// torch's float32 product x_scale * w_scale[o], rounded once
__device__ __forceinline__ float col_scale(const Scale& sc, float xs, int o) {
  return __fmul_rn(xs, sc.ws[o * sc.ws_step]);
}

__device__ __forceinline__ float epilogue(int acc, float s, const float* bias,
                                          float b, int relu) {
  float v = __fmul_rn(__int2float_rn(acc), s);
  if (bias != nullptr) v = __fadd_rn(v, b);
  return relu && !(v > 0.f) ? 0.f : v;
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bytes(const int8_t* p, int n) {
  unsigned u = 0;
  for (int j = 0; j < n; ++j) u |= (unsigned)(uint8_t)p[j] << (8 * j);
  return u;
}

// the first n (1..16) bytes at p as one 16-byte vector, zeros after them
__device__ __forceinline__ uint4 pack16(const int8_t* p, int n) {
  uint4 u = make_uint4(0, 0, 0, 0);
  u.x = pack_bytes(p, n < 4 ? n : 4);
  if (n > 4) u.y = pack_bytes(p + 4, n - 4 < 4 ? n - 4 : 4);
  if (n > 8) u.z = pack_bytes(p + 8, n - 8 < 4 ? n - 8 : 4);
  if (n > 12) u.w = pack_bytes(p + 12, n - 12);
  return u;
}

template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kLds = BK + 16;              // bytes per smem row
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN>::kThreads)
int8_gemm_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                 Scale sc, const float* __restrict__ Bias,
                 float* __restrict__ Out, int M, int K, int O, int x_vec,
                 int w_vec, int relu) {
  using T = Tile<BM, BN, BK, WM, WN>;
  constexpr int LDS = T::kLds;
  __shared__ __align__(16) int8_t As[BM * LDS];    // As[m][k]
  __shared__ __align__(16) int8_t Bt[BN * LDS];    // Bt[n][k]
  __shared__ float Ss[BN], Bs[BN];                 // the tile's s and b

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::kWarpsN) * WM, wn = (warp % T::kWarpsN) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (tid < BN) {              // read in the epilogue, after the K loop's
    const int col = n0 + tid;  // barriers
    Ss[tid] = col < O ? col_scale(sc, x_scale_of(sc), col) : 0.f;
    Bs[tid] = col < O && Bias != nullptr ? Bias[col] : 0.f;
  }

  int acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 16-byte chunks of rows
    for (int c = tid; c < BM * BK / 16; c += T::kThreads) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kc;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        const int8_t* src = X + (size_t)gm * K + gk;
        u = x_vec ? *reinterpret_cast<const uint4*>(src)
                  : pack16(src, K - gk < 16 ? K - gk : 16);
      }
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = u;
    }
    // w tile: 4x4 byte blocks, transposed into Bt[n][k]
    for (int b = tid; b < (BK / 4) * (BN / 4); b += T::kThreads) {
      const int nb = (b % (BN / 4)) * 4, kb = (b / (BN / 4)) * 4;
      const int gn = n0 + nb;
      unsigned r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + kb + i;
        r[i] = 0;
        if (gk < K && gn < O) {
          const int8_t* src = W + (size_t)gk * O + gn;
          r[i] = w_vec ? *reinterpret_cast<const unsigned*>(src)
                       : pack_bytes(src, O - gn < 4 ? O - gn : 4);
        }
      }
      const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
      const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
      *reinterpret_cast<unsigned*>(Bt + (nb + 0) * LDS + kb) =
          __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<unsigned*>(Bt + (nb + 1) * LDS + kb) =
          __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<unsigned*>(Bt + (nb + 2) * LDS + kb) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<unsigned*>(Bt + (nb + 3) * LDS + kb) =
          __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[T::kMT][4], bf[T::kNT][2];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int8_t* p = Bt + (wn + j * 8 + g) * LDS + kk + 4 * t;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (row < M && col < O)
          Out[(size_t)row * O + col] = epilogue(
              acc[i][j][e], Ss[col - n0], Bias, Bs[col - n0], relu);
      }
}

// ---- decode (M <= 16): split K over a thread-block cluster ------------------

constexpr int DEC_BN = 32;          // output columns of a block
constexpr int DEC_BK = 64;          // k rows of a stage
constexpr int DEC_STAGES = 8;       // the ring of w (and x) stages
constexpr int DEC_THREADS = 128;    // 4 warps, one 8-column slice each
constexpr int DEC_XS = DEC_BK + 16; // bytes of an x row in shared memory
constexpr int DEC_MAX_SPLIT = 8;    // the portable cluster size

// the shared-memory row of w's k row r (rows of DEC_BN bytes): within each
// group of 4 rows, row r sits at slot (r ^ (r >> 2)) & 3, so the rows
// kk + 4t + i (t = 0..3) that one B-fragment read spans fall on 4
// different 8-bank groups
__device__ __forceinline__ int dec_wrow(int r) {
  return (r & ~3) | ((r ^ (r >> 2)) & 3);
}

// stage k rows k0 .. k0 + DEC_BK - 1 of w (columns n0 .. n0 + 31) and of
// the x row block into one slot of the ring, zeros past M, K and O;
// 16-byte cp.async copies where the operand allows them, else bytes
__device__ __forceinline__ void dec_load(int8_t* ws, int8_t* xs,
                                         const int8_t* __restrict__ X,
                                         const int8_t* __restrict__ W, int M,
                                         int K, int O, int n0, int k0,
                                         int x_vec, int w_vec16) {
  const int tid = threadIdx.x;
  {                                        // w: 64 rows x 2 chunks
    const int r = tid >> 1, ch = tid & 1;
    const int gk = k0 + r, gn = n0 + 16 * ch;
    int8_t* dst = ws + dec_wrow(r) * DEC_BN + 16 * ch;
    const bool ok = gk < K && gn < O;
    if (w_vec16)
      cp_async16(dst, ok ? W + (size_t)gk * O + gn : W, ok ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) =
          ok ? pack16(W + (size_t)gk * O + gn, O - gn < 16 ? O - gn : 16)
             : make_uint4(0, 0, 0, 0);
  }
  if (tid < 16 * (DEC_BK / 16)) {          // x: 16 rows x 4 chunks
    const int r = tid >> 2, ch = tid & 3;
    const int gk = k0 + 16 * ch;
    int8_t* dst = xs + r * DEC_XS + 16 * ch;
    const bool ok = r < M && gk < K;
    if (x_vec)
      cp_async16(dst, ok ? X + (size_t)r * K + gk : X, ok ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) =
          ok ? pack16(X + (size_t)r * K + gk, K - gk < 16 ? K - gk : 16)
             : make_uint4(0, 0, 0, 0);
  }
}

// the B fragment word of column c for k rows r .. r + 3 of a w stage: the
// byte c & 3 of four row words, gathered by __byte_perm
__device__ __forceinline__ unsigned dec_bcol(const int8_t* ws, int r, int c) {
  const int8_t* p = ws + (c & ~3);
  const unsigned w0 = *reinterpret_cast<const unsigned*>(p + dec_wrow(r) * DEC_BN);
  const unsigned w1 =
      *reinterpret_cast<const unsigned*>(p + dec_wrow(r + 1) * DEC_BN);
  const unsigned w2 =
      *reinterpret_cast<const unsigned*>(p + dec_wrow(r + 2) * DEC_BN);
  const unsigned w3 =
      *reinterpret_cast<const unsigned*>(p + dec_wrow(r + 3) * DEC_BN);
  const unsigned sel = (c & 3) | ((4 + (c & 3)) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel),
                     0x5410);
}

// Cluster of `split` blocks along K (grid (split, O tiles)): block rank r
// streams its share of K's stages of w through a cp.async ring and keeps
// a 16 x 32 int32 partial in registers (warp w: columns 8w .. 8w + 7).
// Rank o owns outputs o * per .. (o + 1) * per - 1 (per = 512 / split):
// every rank writes the part of its partial that rank o owns into rank
// o's shared memory (distributed shared memory), one cluster barrier
// later each rank sums what it received and runs the epilogue. The scales
// and biases of a thread's outputs are loaded before the K loop, so their
// latency hides behind w's.
__global__ void __launch_bounds__(DEC_THREADS)
int8_decode_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                   Scale sc, const float* __restrict__ Bias,
                   float* __restrict__ Out, int M, int K, int O, int x_vec,
                   int w_vec16, int relu) {
  __shared__ __align__(128) int8_t Ws[DEC_STAGES][DEC_BK * DEC_BN];
  __shared__ __align__(128) int8_t Xs[DEC_STAGES][16 * DEC_XS];
  constexpr int MAX_OUT = 16 * DEC_BN / DEC_THREADS;   // outputs a thread
  __shared__ int recv[16 * DEC_BN];        // [rank][per]: partials to sum
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = blockIdx.y * DEC_BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (K + DEC_BK - 1) / DEC_BK;
  const int s0 = (int)((long long)rank * steps / split);
  const int n = (int)((long long)(rank + 1) * steps / split) - s0;
  const int per = 16 * DEC_BN / split;     // split is a power of two <= 8
  cluster_arrive_relaxed();                // this block has started
  float so[MAX_OUT], bi[MAX_OUT];          // this thread's outputs' s, b
  const float xsf = x_scale_of(sc);
#pragma unroll
  for (int q = 0; q < MAX_OUT; ++q) {
    const int e = tid + q * DEC_THREADS, o = n0 + (rank * per + e) % DEC_BN;
    so[q] = bi[q] = 0.f;
    if (e < per && o < O) {
      so[q] = col_scale(sc, xsf, o);
      if (Bias != nullptr) bi[q] = Bias[o];
    }
  }

#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < n)
      dec_load(Ws[st], Xs[st], X, W, M, K, O, n0, (s0 + st) * DEC_BK, x_vec,
               w_vec16);
    cp_async_commit();
  }
  int acc[4] = {0, 0, 0, 0};
  const int c = 8 * warp + g;              // this thread's B column
  for (int it = 0; it < n; ++it) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();                       // stage `it` landed; it - 1 read
    const int nxt = it + DEC_STAGES - 1;
    if (nxt < n)
      dec_load(Ws[nxt % DEC_STAGES], Xs[nxt % DEC_STAGES], X, W, M, K, O, n0,
               (s0 + nxt) * DEC_BK, x_vec, w_vec16);
    cp_async_commit();
    const int8_t* ws = Ws[it % DEC_STAGES];
    const int8_t* xs = Xs[it % DEC_STAGES];
#pragma unroll
    for (int kk = 0; kk < DEC_BK; kk += 32) {
      const int8_t* p = xs + g * DEC_XS + kk + 4 * t;
      const unsigned a[4] = {
          *reinterpret_cast<const unsigned*>(p),
          *reinterpret_cast<const unsigned*>(p + 8 * DEC_XS),
          *reinterpret_cast<const unsigned*>(p + 16),
          *reinterpret_cast<const unsigned*>(p + 8 * DEC_XS + 16)};
      const unsigned b[2] = {dec_bcol(ws, kk + 4 * t, c),
                             dec_bcol(ws, kk + 16 + 4 * t, c)};
      mma_s8(acc, a, b);
    }
  }
  cp_async_wait<0>();

  // c0, c1 at row g, columns 2t, 2t + 1 of the warp's slice; c2, c3 row
  // g + 8: each to the recv[rank] slot of the rank that owns it
  cluster_wait();                          // every block has started
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int idx = (g + (e >= 2 ? 8 : 0)) * DEC_BN + 8 * warp + 2 * t + (e & 1);
    cluster.map_shared_rank(&recv[0], idx / per)[rank * per + idx % per] =
        acc[e];
  }
  cluster.sync();                          // every partial has arrived
#pragma unroll
  for (int q = 0; q < MAX_OUT; ++q) {
    const int e = tid + q * DEC_THREADS;
    const int idx = rank * per + e, row = idx / DEC_BN, o = n0 + idx % DEC_BN;
    if (e < per && row < M && o < O) {
      int sum = 0;                         // int32: exact in any order
      for (int r = 0; r < split; ++r) sum += recv[r * per + e];
      Out[(size_t)row * O + o] = epilogue(sum, so[q], Bias, bi[q], relu);
    }
  }
}

// ---- M > 16: TMA-fed int8 wgmma on the K-major weight ------------------------

constexpr int WG_BN = 128;          // output columns of a tile
constexpr int WG_BK = 128;          // k bytes of a stage: one swizzle row

// NWG consumer warpgroups of 64 rows each; shared memory (every tile on a
// 1024-byte boundary): a ring of stages, each an x tile (BM x 128) and a
// w tile (128 x 128), then the full and empty barriers. 96 KB either way,
// so two blocks share an SM
template <int NWG> struct WgPlan {
  static constexpr int BM = 64 * NWG;
  static constexpr int STAGES = NWG == 2 ? 3 : 4;
  static constexpr int A_BYTES = BM * WG_BK;
  static constexpr int STAGE = A_BYTES + WG_BN * WG_BK;
  static constexpr int THREADS = 128 * NWG + 32;      // + the producer warp
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SB_OFF = BAR_OFF + 2 * STAGES * 8;  // scales, biases
  static constexpr int bytes = SB_OFF + 2 * WG_BN * 4 + 1024;
};

// One (BM x 128) output tile a block. The producer warp's first lane
// loads each k step's x and w tiles into the next free stage (full/empty
// mbarriers); each consumer warpgroup multiplies its 64 rows by the
// stage's 128 columns, 4 wgmma of k 32 a stage, keeping one stage's
// products in flight: the stage before goes back once they retire. The
// tile's 128 scales and biases are staged in shared memory before the K
// loop (read from device memory between the epilogue's stores they would
// wait one memory latency each). The epilogue runs from the accumulator
// registers: thread (warp w, lane) holds rows 16 w + lane / 4 (+ 8) and
// columns 8 j + 2 (lane % 4) (+ 1).
template <int NWG>
__global__ void __launch_bounds__(WgPlan<NWG>::THREADS, 2)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, Scale sc,
                  const float* __restrict__ Bias, float* __restrict__ Out,
                  int M, int K, int O, int relu) {
  using P = WgPlan<NWG>;
  constexpr int S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.y * P::BM, n0 = blockIdx.x * WG_BN;
  const int steps = (K + WG_BK - 1) / WG_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);       // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {                   // ---- producer
    if (lane == 0) {
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::STAGE);
        tma_load_2d(base + s * P::STAGE, &tx, &full[s], kt * WG_BK, m0);
        tma_load_2d(base + s * P::STAGE + P::A_BYTES, &tw, &full[s],
                    kt * WG_BK, n0);
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp >> 2;
  float* sb = reinterpret_cast<float*>(base + P::SB_OFF);   // s[128], b[128]
  if (tid < WG_BN) {
    const int col = n0 + tid;
    sb[tid] = col < O ? col_scale(sc, x_scale_of(sc), col) : 0.f;
    sb[WG_BN + tid] = col < O && Bias != nullptr ? Bias[col] : 0.f;
  }
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint8_t* as = base + s * P::STAGE + wg * 64 * WG_BK;
    const uint8_t* bs = base + s * P::STAGE + P::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_n128(acc, sw128_desc(as + 32 * kk, 16),
                    sw128_desc(bs + 32 * kk, 16), 1);
    wg_commit();
    wg_wait<1>();                          // step kt - 1's products retired
    wg_hold(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wg_wait<0>();
  wg_hold(acc);
  named_sync(1, 128 * NWG);                // the scales and biases are in

  const int r0 = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  const bool pairs = (O & 1) == 0;         // float2 stores stay aligned
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= O) continue;
    const bool two = col + 1 < O;
    const int c = col - n0;
    const float s0 = sb[c], s1 = sb[c + 1];
    const float b0 = sb[WG_BN + c], b1 = sb[WG_BN + c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? r1 : r0;
      if (row >= M) continue;
      const float v0 = epilogue(acc[4 * j + 2 * h], s0, Bias, b0, relu);
      const float v1 = epilogue(acc[4 * j + 2 * h + 1], s1, Bias, b1, relu);
      float* dst = Out + (size_t)row * O + col;
      if (two && pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (two) dst[1] = v1;
      }
    }
  }
}

// the smallest power-of-two split (at most the cluster size, and at most
// one stage per rank) that gives every SM two blocks: shorter chains of
// stages per block, and a second block to run while one waits
int decode_split(int K, int O) {
  const int sms = sm_count();
  const int tiles = (O + DEC_BN - 1) / DEC_BN;
  const int steps = (K + DEC_BK - 1) / DEC_BK;
  int split = 1;
  while (split < DEC_MAX_SPLIT && tiles * split < 2 * sms &&
         2 * split <= steps)
    split *= 2;
  return split;
}

cudaError_t launch_decode(const int8_t* X, const int8_t* W, const Scale& sc,
                          const float* B, float* Out, int M, int K, int O,
                          int x_vec, int relu, cudaStream_t stream) {
  const int split = decode_split(K, O);
  const int w_vec16 = reinterpret_cast<uintptr_t>(W) % 16 == 0 && O % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (O + DEC_BN - 1) / DEC_BN, 1);
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_decode_kernel, X, W, sc, B, Out, M, K,
                            O, x_vec, w_vec16, relu);
}

template <int NWG>
cudaError_t launch_wgmma(const int8_t* X, const int8_t* WK, const Scale& sc,
                         const float* B, float* Out, int M, int K, int O,
                         int relu, cudaStream_t stream) {
  using P = WgPlan<NWG>;
  CUtensorMap tx, tw;
  if (!map_kmajor_s8(&tx, X, M, K, P::BM) ||
      !map_kmajor_s8(&tw, WK, O, K, WG_BN))
    return cudaErrorInvalidValue;
  static bool configured = false;          // above 48 KB needs an opt-in
  const cudaError_t e = allow_smem(int8_wgmma_kernel<NWG>, P::bytes,
                                   configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((O + WG_BN - 1) / WG_BN, (M + P::BM - 1) / P::BM);
  int8_wgmma_kernel<NWG><<<grid, P::THREADS, P::bytes, stream>>>(
      tx, tw, sc, B, Out, M, K, O, relu);
  return cudaSuccess;
}

template <int BM, int BN, int BK, int WM, int WN>
void launch(const int8_t* X, const int8_t* W, const Scale& sc, const float* B,
            float* Out, int M, int K, int O, int x_vec, int w_vec, int relu,
            cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WM, WN>;
  const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<BM, BN, BK, WM, WN><<<grid, T::kThreads, 0, stream>>>(
      X, W, sc, B, Out, M, K, O, x_vec, w_vec, relu);
}

}  // namespace
}  // namespace mxt

// X (M, K) int8, W (K, O) int8, WK (O, K) int8 (the K-major copy of W, for
// route 1), Bias (O,) float32 or null, Out (M, O) float32; all contiguous.
// The scale: XS a 0-d float32 (xs_bf16 0) or bfloat16 (xs_bf16 1) on the
// device, or null and xs_host; WS float32, (O,) with ws_step 1 or (1,)
// with ws_step 0. route: 0 the split-K decode kernel (M <= 16), 1 int8
// wgmma (X and WK 16-byte aligned, K % 16 == 0), 2 mma.sync (any shape).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for a route
// the operands do not allow).
extern "C" int mx_int8_matmul(const void* X, const void* W, const void* WK,
                              const void* XS, int xs_bf16, float xs_host,
                              const void* WS, int ws_step, const void* Bias,
                              void* Out, int M, int K, int O, int route,
                              int relu, void* stream) {
  using namespace mxt;
  if (M <= 0 || K <= 0 || O <= 0) return cudaErrorInvalidValue;
  const int8_t* x = static_cast<const int8_t*>(X);
  const int8_t* w = static_cast<const int8_t*>(W);
  const Scale sc{XS, xs_bf16, xs_host, static_cast<const float*>(WS), ws_step};
  const float* b = static_cast<const float*>(Bias);
  float* out = static_cast<float*>(Out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int x_vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 && K % 16 == 0;
  cudaError_t e = cudaSuccess;
  if (route == 0 && M <= 16) {
    e = launch_decode(x, w, sc, b, out, M, K, O, x_vec, relu, st);
  } else if (route == 1 && x_vec && WK != nullptr &&
             reinterpret_cast<uintptr_t>(WK) % 16 == 0) {
    const int8_t* wk = static_cast<const int8_t*>(WK);
    // two consumer warpgroups when the 128-row tiles alone fill the card
    const int tiles = ((M + 127) / 128) * ((O + WG_BN - 1) / WG_BN);
    e = tiles >= sm_count()
            ? launch_wgmma<2>(x, wk, sc, b, out, M, K, O, relu, st)
            : launch_wgmma<1>(x, wk, sc, b, out, M, K, O, relu, st);
  } else if (route == 2) {
    const int w_vec = reinterpret_cast<uintptr_t>(W) % 4 == 0 && O % 4 == 0;
    launch<64, 64, 128, 32, 32>(x, w, sc, b, out, M, K, O, x_vec, w_vec, relu,
                                st);
  } else {
    return cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}
